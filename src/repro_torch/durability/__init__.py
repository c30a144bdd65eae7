"""repro_torch.durability — fault injection for the port's dispatch and
serving layers (the port's copy of ``repro.durability``'s faults; the
write-ahead trace journal stays in the reference package).

Per-backend error / timeout / latency-spike / slow-start probabilities
with a seeded RNG, threaded through the dispatcher and the serving
backend for deterministic chaos testing.
"""

from .faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    InjectedFault,
    InjectedTimeout,
)

__all__ = ["FaultPlan", "FaultInjector", "InjectedFault", "InjectedTimeout"]
