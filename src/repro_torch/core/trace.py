"""External-call traces and the ≡_A equivalence relation (paper §4.3),
generalized to per-effect-domain projections (DESIGN.md §2.2).

A *trace* is the sequence of external calls a program makes.  PopPy's
soundness guarantee is that its trace is ≡_A-equivalent to the standard
sequential Python trace.  With effect-domain-keyed sequence variables the
guarantee holds **per domain** — for every domain ``d`` (each concrete key
plus ``"*"``), projecting both traces onto the events that touch ``d``
(events keyed ``d`` or keyed ``"*"``, which joins every domain):

  * ``sequential`` calls of the projection appear in exactly the same
    order;
  * ``readonly`` calls may permute among themselves but stay within the
    same window between consecutive sequential calls of the projection;
  * ``unordered`` calls may appear anywhere (one global multiset equality
    — they never order with anything).

When every event carries the default ``("*",)`` key, every projection is
the full trace and this is exactly the paper's single-domain Prop. 1.

The checker below is used by the differential and property-based tests.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import Counter
from dataclasses import dataclass, field


def safe_repr(v, limit=200):
    try:
        r = repr(v)
    except Exception:  # pragma: no cover
        r = f"<unreprable {type(v).__name__}>"
    if len(r) > limit:
        r = r[:limit] + "…"
    return r


@dataclass
class TraceEvent:
    """One external call's queue/dispatch/resolve record (the =_A unit)."""

    name: str
    callsite: str = ""
    cls: str = ""
    # Timestamps are seconds since the owning Trace's monotonic origin
    # (``Trace.t0``), so events from different traces of the same run
    # shape are directly comparable and exporters need no re-basing;
    # ``Trace.epoch`` carries the matching wall-clock time.
    t_queue: float = 0.0
    t_dispatch: float = 0.0
    t_resolve: float = 0.0
    args_repr: str = ""
    seq_no: int = -1  # dispatch order
    # wrapped=True → an annotation-wrapper external, observable in both
    # plain-Python and PopPy runs; the ≡_A checker compares only these
    # (operators/builtins are not interceptable under standard Python).
    wrapped: bool = True
    # effect-domain keys (DESIGN.md §2.2); ("*",) = the global domain.
    # Declared (annotation-level) keys are deterministic functions of the
    # arguments, so they match across plain and PopPy runs; anonymous
    # ``obj:``-keyed intrinsic events are unwrapped and never compared.
    effects: tuple = ("*",)
    # speculation segment (DESIGN.md §2.4): 0 = committed trace; a
    # non-zero segment holds events recorded inside a still-speculative
    # branch arm.  Commit retags the segment into its parent; abort
    # discards it, so a finished run's trace only ever contains seg-0
    # events and ≡_A comparisons see exactly the committed behavior.
    seg: int = 0


@dataclass
class Trace:
    """Event recording is thread-safe: external code runs on the offload
    executor's worker threads (and the ai bridge loop), and an external may
    record events — directly or via annotated calls it makes — from any of
    them concurrently with the engine thread."""

    events: list[TraceEvent] = field(default_factory=list)
    # monotonic origin: every event timestamp is relative to this instant
    t0: float = field(default_factory=time.monotonic)
    # wall-clock time at ``t0`` — aligns traces across processes
    epoch: float = field(default_factory=time.time)
    _seq: int = field(default=0, repr=False)
    _nseg: int = field(default=0, repr=False)
    # segments discarded by speculative rollback: events tagged with a
    # dead segment are dropped, and late recordings into one (a losing
    # arm's controller between queue and cancellation) are never appended
    _dead_segs: set = field(default_factory=set, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def now(self) -> float:
        """Seconds since this trace's monotonic origin."""
        return time.monotonic() - self.t0

    def _next_seq(self) -> int:
        with self._lock:
            n = self._seq
            self._seq += 1
            return n

    # -- engine-side API --------------------------------------------------

    def queued(self, name, callsite="", wrapped=True) -> TraceEvent:
        seg = _segment_var.get()
        ev = TraceEvent(name=name, callsite=callsite,
                        t_queue=self.now(), wrapped=wrapped, seg=seg)
        with self._lock:
            if seg not in self._dead_segs:
                self.events.append(ev)
        return ev

    def classified(self, ev: TraceEvent, cls: str, effects=None):
        ev.cls = cls
        if effects is not None:
            ev.effects = tuple(effects)

    def set_effects(self, ev: TraceEvent, effects):
        """Overwrite with the *declared* keys once arguments resolved (the
        locking keys may have been conservatively degraded to ``"*"``)."""
        ev.effects = tuple(effects)

    def dispatched(self, ev: TraceEvent, args_repr=""):
        ev.t_dispatch = self.now()
        ev.args_repr = args_repr
        ev.seq_no = self._next_seq()

    def resolved(self, ev: TraceEvent):
        ev.t_resolve = self.now()

    # -- speculative segments (DESIGN.md §2.4) -------------------------------

    def new_segment(self) -> int:
        """Open a fresh speculative segment id (never 0)."""
        with self._lock:
            self._nseg += 1
            return self._nseg

    def commit_segment(self, seg: int, into: int = 0):
        """Merge a winning arm's events into the parent segment (``into=0``
        commits to the main trace)."""
        with self._lock:
            for e in self.events:
                if e.seg == seg:
                    e.seg = into

    def drop_segment(self, seg: int) -> int:
        """Discard a losing arm's events; returns how many were dropped.
        The segment is also marked dead so in-flight recordings from its
        (cancelling) tasks cannot resurface."""
        with self._lock:
            self._dead_segs.add(seg)
            before = len(self.events)
            self.events = [e for e in self.events if e.seg != seg]
            return before - len(self.events)

    def drop_event(self, ev: TraceEvent) -> bool:
        """Discard one event (a stale predict-and-validate attempt that is
        being re-executed with the actual value)."""
        with self._lock:
            for i, e in enumerate(self.events):
                if e is ev:
                    del self.events[i]
                    return True
            return False

    # -- plain-Python-side API ---------------------------------------------

    def record_direct(self, name, cls, args_repr="", callsite="",
                      effects=("*",)):
        now = self.now()
        ev = TraceEvent(name=name, callsite=callsite, cls=cls,
                        t_queue=now, t_dispatch=now, t_resolve=now,
                        args_repr=args_repr, seq_no=self._next_seq(),
                        wrapped=True, effects=tuple(effects))
        with self._lock:
            self.events.append(ev)
        return ev

    # -- views ---------------------------------------------------------------

    def dispatch_order(self, only_wrapped=False) -> list[TraceEvent]:
        evs = [e for e in self.events
               if e.seq_no >= 0 and (e.wrapped or not only_wrapped)]
        evs.sort(key=lambda e: e.seq_no)
        return evs

    def keys(self, only_wrapped=True):
        return [(e.name, e.cls, e.args_repr, e.effects)
                for e in self.dispatch_order(only_wrapped=only_wrapped)]

    def domain_summary(self, only_wrapped=True) -> dict:
        """Per-effect-domain dispatch counts (observability)."""
        out: dict[str, int] = {}
        for e in self.dispatch_order(only_wrapped=only_wrapped):
            for d in e.effects:
                out[d] = out.get(d, 0) + 1
        return out


_current_trace: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "poppy_trace", default=None)

#: Ambient speculative segment: tasks spawned while expanding a
#: speculative branch arm inherit its segment id (contextvars copy), so
#: every event they record lands in the arm's discardable segment.
_segment_var: contextvars.ContextVar[int] = contextvars.ContextVar(
    "poppy_trace_segment", default=0)


def current_trace() -> Trace | None:
    return _current_trace.get()


def current_segment() -> int:
    return _segment_var.get()


def set_segment(seg: int):
    return _segment_var.set(seg)


def reset_segment(token):
    _segment_var.reset(token)


class recording:
    """Context manager: capture all external-call events into a Trace."""

    def __init__(self):
        self.trace = Trace()

    def __enter__(self) -> Trace:
        self._tok = _current_trace.set(self.trace)
        return self.trace

    def __exit__(self, *exc):
        _current_trace.reset(self._tok)
        return False


# ---------------------------------------------------------------------------
# ≡_A equivalence


def _segments(keys):
    """Split a dispatch-ordered (name, cls, args) list at sequential events.

    Returns (sequential_keys, readonly_segments) where readonly_segments[i]
    is the multiset of readonly calls between the i-th and (i+1)-th
    sequential call.
    """
    seq = []
    ro_segments = [Counter()]
    for name, cls, args in keys:
        k = (name, args)
        if cls == "sequential":
            seq.append(k)
            ro_segments.append(Counter())
        else:
            ro_segments[-1][k] += 1
    return seq, ro_segments


def _project(keys, domain):
    """Ordered (sequential/readonly) events of one domain's projection: an
    event participates if it is keyed to ``domain`` or keyed ``"*"`` (a
    ``"*"`` call joins every domain)."""
    return [(name, cls, args) for name, cls, args, effs in keys
            if cls in ("sequential", "readonly")
            and ("*" in effs or domain in effs)]


def _check_projection(ka, kb, domain) -> tuple[bool, str]:
    sa, ra = _segments(_project(ka, domain))
    sb, rb = _segments(_project(kb, domain))
    where = f" in domain {domain!r}" if domain != "*" else ""
    if sa != sb:
        for i, (x, y) in enumerate(zip(sa, sb)):
            if x != y:
                return False, (f"sequential calls diverge at #{i}{where}: "
                               f"{x} vs {y}")
        return False, (f"sequential call count differs{where}: "
                       f"{len(sa)} vs {len(sb)}")
    if len(ra) != len(rb):  # pragma: no cover - implied by sa == sb
        return False, f"internal error: segment count mismatch{where}"
    for i, (x, y) in enumerate(zip(ra, rb)):
        if x != y:
            return False, (f"readonly calls differ in segment {i}{where}: "
                           f"{(x - y) + (y - x)}")
    return True, "equivalent"


def equivalent(trace_a: Trace, trace_b: Trace) -> tuple[bool, str]:
    """Check trace_a ≡_A trace_b, per effect domain (Prop. 1 per-domain:
    every domain's projection must satisfy the single-domain relation).
    Returns (ok, explanation)."""
    ka = trace_a.keys()
    kb = trace_b.keys()
    # unordered calls never order with anything: one global multiset
    ua = Counter((n, a) for n, c, a, _ in ka if c == "unordered")
    ub = Counter((n, a) for n, c, a, _ in kb if c == "unordered")
    if ua != ub:
        return False, f"unordered multiset differs: {(ua - ub) + (ub - ua)}"
    domains = {"*"}
    for keys in (ka, kb):
        for _, cls, _, effs in keys:
            if cls in ("sequential", "readonly"):
                domains.update(effs)
    for d in sorted(domains):
        ok, why = _check_projection(ka, kb, d)
        if not ok:
            return False, why
    return True, "equivalent"
