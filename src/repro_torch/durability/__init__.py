"""repro_torch.durability — crash-safe execution tier (DESIGN.md §2.5);
the port's copy of ``repro.durability``.

Two pillars, both grounded in PopPy's deterministic trace (Prop. 1):

* **Write-ahead trace journal** (`journal.py`): every committed external
  resolution is appended to an fsync'd JSONL file as it lands; a
  restarted run under :func:`resume` replays journaled results into the
  value/lock-chain machinery instead of re-paying the calls, completing
  byte-identically to the uninterrupted run.  Entries are keyed by the
  dispatch layer's request hash, which both packages compute alike, so a
  journal recorded under either package resumes under the other.
* **Fault injection** (`faults.py`): per-backend error / timeout /
  latency-spike / slow-start probabilities with a seeded RNG, threaded
  through the dispatcher and the serving backend for deterministic chaos
  testing.
"""

from .faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    InjectedFault,
    InjectedTimeout,
)
from .journal import (  # noqa: F401
    KILL_EXIT,
    Journal,
    JournalStats,
    current_journal,
    resume,
    use_journal,
)

__all__ = [
    "Journal", "JournalStats", "use_journal", "resume", "current_journal",
    "KILL_EXIT",
    "FaultPlan", "FaultInjector", "InjectedFault", "InjectedTimeout",
]
