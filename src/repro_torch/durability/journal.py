"""Write-ahead trace journal: crash-safe replay of committed externals
(DESIGN.md §2.5).

PopPy's trace is deterministic per effect domain (Prop. 1 ≡_A), which
makes crash recovery a pure replay problem: if each external's resolved
value is journaled *as it commits*, a restarted run can serve the same
calls from the journal — skipping re-execution (and re-payment of
seconds-long LLM calls, and re-performance of already-committed effects)
— and then continue live exactly where the crashed run stopped.

Mechanics:

* Entries are keyed by the dispatch-layer stable request hash
  (:func:`repro_torch.dispatch.cache.request_key`) over the external's name and
  fully-resolved arguments, plus a per-key *occurrence index* so repeated
  identical calls map one-to-one onto their journaled resolutions.
* Appends are atomic at line granularity and fsync'd by default; a crash
  mid-append leaves at most one torn trailing line, which :meth:`resume
  <Journal>` loading tolerates (the torn tail is dropped, its call simply
  re-executes).
* Only *committed* trace entries are journaled: the engine hooks skip any
  call resolving inside a speculative segment
  (``repro_torch.core.trace.current_segment() != 0``), so a losing arm's
  resolutions never enter the journal (DESIGN.md §2.4).
* Values must survive the JSON codec round-trip (the dispatch disk-cache
  codec, tuples tagged); a non-serializable result is *skipped* — counted,
  never fatal — and simply re-executes on resume.

Usage::

    from repro_torch.durability import use_journal, resume

    with use_journal("run.journal"):          # record mode (fresh file)
        out = app(task)                        # ...killed mid-run...

    with resume("run.journal") as j:           # replay + continue
        out = app(task)                        # byte-identical result
    print(j.stats.replayed, "of", j.stats.loaded, "calls replayed")
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
from dataclasses import dataclass
from pathlib import Path

from repro_torch.dispatch.cache import _decode, _encode, request_key

#: Exit code used by the deterministic crash hook (``kill_after=``): the
#: chaos harness asserts on it to distinguish the injected kill from a
#: genuine failure.
KILL_EXIT = 86

_MISS = object()


@dataclass
class JournalStats:
    """Counters for one journal's lifetime (record or resume)."""

    loaded: int = 0     # entries read from disk at resume
    replayed: int = 0   # calls served from the journal (not re-executed)
    appended: int = 0   # fresh resolutions written this run
    skipped: int = 0    # resolutions not journalable (codec round-trip)
    torn: int = 0       # trailing lines dropped at load (crash mid-append)

    @property
    def replay_fraction(self) -> float:
        """Fraction of journaled entries served back on resume."""
        return self.replayed / self.loaded if self.loaded else 0.0


class Journal:
    """Append-only JSONL journal of committed external resolutions.

    ``mode="record"`` starts a fresh journal (truncating any existing
    file); ``mode="resume"`` loads the surviving entries of a previous
    run and appends everything executed live after the replay prefix —
    so a resumed run that crashes again can itself be resumed.

    ``fsync=False`` trades the per-append fsync for speed (the line is
    still flushed to the OS).  ``kill_after=N`` is the chaos-test hook:
    the process hard-exits (``os._exit(KILL_EXIT)``) immediately after
    the N-th append lands on disk, simulating a crash at a deterministic
    journal position.
    """

    def __init__(self, path, mode: str = "record", *, fsync: bool = True,
                 kill_after: int | None = None):
        if mode not in ("record", "resume"):
            raise ValueError(f"journal mode must be 'record' or 'resume', "
                             f"got {mode!r}")
        self.path = Path(path)
        self.mode = mode
        self.fsync = fsync
        self.kill_after = kill_after
        self.stats = JournalStats()
        self._lock = threading.Lock()
        self._seen: dict[str, int] = {}       # key -> occurrences claimed
        self._loaded: dict[str, list] = {}    # key -> values, in order
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if mode == "resume":
            self._load()
            self._fh = open(self.path, "a", encoding="utf-8")
        else:
            self._fh = open(self.path, "w", encoding="utf-8")

    # -- load ----------------------------------------------------------------

    def _load(self):
        try:
            text = self.path.read_text(encoding="utf-8")
        except OSError:
            return  # no previous journal: resume degenerates to record
        for line in text.splitlines():
            if not line.strip():
                continue
            try:
                d = json.loads(line)
                key, value = d["key"], _decode(d["value"])
            except (ValueError, KeyError, TypeError):
                # a crash mid-append can tear only the *last* line; stop
                # here — anything after a torn line is unaccounted for
                self.stats.torn += 1
                break
            self._loaded.setdefault(key, []).append(value)
            self.stats.loaded += 1

    # -- record/replay protocol ---------------------------------------------

    @staticmethod
    def _key(name: str, pos, kw) -> str:
        # full (untruncated) repr of the resolved arguments: the same
        # stable hashing the dispatch cache uses, over the same kind of
        # primitive-built payload
        return request_key(name, repr((tuple(pos), sorted(kw.items()))))

    def claim(self, name: str, pos, kw):
        """Claim the next occurrence of ``(name, args)``.

        Returns ``(hit, token, value)``: on a hit the journaled ``value``
        stands in for the call; on a miss the caller executes the call and
        passes ``token`` to :meth:`append` with the live result.
        """
        key = self._key(name, pos, kw)
        with self._lock:
            n = self._seen.get(key, 0)
            self._seen[key] = n + 1
            vals = self._loaded.get(key)
            if vals is not None and n < len(vals):
                self.stats.replayed += 1
                return True, None, vals[n]
        return False, (key, n, name), None

    def append(self, token, value, *, effects=("*",), seq: int = -1):
        """Journal one committed resolution (write + flush + fsync).

        ``effects``/``seq`` record the call's effect-domain position in
        the committed trace — diagnostic provenance for journal audits.
        A value the JSON codec cannot round-trip is skipped (counted);
        the call will re-execute on resume, which is always sound for
        the deterministic externals PopPy targets.
        """
        key, n, name = token
        try:
            blob = json.dumps({
                "key": key, "n": n, "name": name,
                "effects": list(effects), "seq": seq,
                "value": _encode(value),
            })
            if _decode(json.loads(blob)["value"]) != value:
                raise ValueError("codec round-trip mismatch")
        except (TypeError, ValueError):
            with self._lock:
                self.stats.skipped += 1
            return
        with self._lock:
            if self._fh.closed:  # late append after the context exited
                self.stats.skipped += 1
                return
            self._fh.write(blob + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self.stats.appended += 1
            done = self.stats.appended
        if self.kill_after is not None and done >= self.kill_after:
            # chaos hook: die *hard* right after the append is durable —
            # no atexit handlers, no executor drains, exactly what a
            # SIGKILL mid-run looks like to the journal
            os._exit(KILL_EXIT)

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __repr__(self):
        return (f"<Journal {self.path} mode={self.mode} "
                f"loaded={self.stats.loaded} replayed={self.stats.replayed} "
                f"appended={self.stats.appended}>")


_journal_var: contextvars.ContextVar[Journal | None] = \
    contextvars.ContextVar("poppy_journal", default=None)


def current_journal() -> Journal | None:
    """The ambient journal for runtimes started in this context."""
    return _journal_var.get()


class use_journal:
    """Context manager: journal every committed external resolution of
    runs started inside.  Accepts a :class:`Journal` or a path (opened in
    ``record`` mode); the journal is closed on exit."""

    def __init__(self, journal, mode: str = "record", **kw):
        self.journal = journal if isinstance(journal, Journal) \
            else Journal(journal, mode=mode, **kw)

    def __enter__(self) -> Journal:
        self._tok = _journal_var.set(self.journal)
        return self.journal

    def __exit__(self, *exc):
        _journal_var.reset(self._tok)
        self.journal.close()
        return False


def resume(journal, **kw) -> use_journal:
    """Resume from a previous run's journal: journaled resolutions replay
    (in value and lock-chain position), everything past the replay prefix
    executes live and is appended — so an interrupted run completes
    byte-identically and a resumed run is itself resumable."""
    return use_journal(journal, mode="resume", **kw)
