"""Span tracing for the port's PopPy runtime and serving engine.

The port's own copy of ``repro/obs/spans.py``, with its own context
variables: the port imports nothing of ``repro``.  The port's runtime
(``repro_torch.core``) and engine both read :func:`current_tracer`, so one
``tracing()`` records a program's externals, its dispatch and the engine's
prefill chunks and decode steps on one timeline.  The engine uses a tracer
only through ``begin``, ``end``, ``span`` and ``event``, so a program of
the reference's core can still trace it: enter both packages'
``tracing(trz)`` with the same tracer.

A *span* is a named time interval on a *track* (a display lane: an effect
domain, a backend replica, a decode slot, an offload worker thread).  Spans
carry a parent link, so a finished run yields a tree: the engine run at the
root, one ``external`` span per queued call, and inside it the phases the
call actually spent time in (argument resolution, lock-chain waits per
effect domain, the dispatch itself, batch windows, backend attempts).

Design constraints, in order:

1. **Off means free.**  Tracing is disabled by default; every instrumented
   site guards on :func:`current_tracer` — one ``ContextVar.get`` — and the
   shared :func:`maybe_span` null context manager allocates nothing.
2. **Context propagation is the parent link.**  The current span lives in a
   ``contextvars.ContextVar``; asyncio copies the context at
   ``create_task`` time, the engine's offload executor runs targets under
   ``ctx.run``, and the sync-client bridge loop adopts the caller's
   context — so parent links survive task switches, worker threads, and
   the bridge loop without any per-layer plumbing.
3. **Thread-safe recording.**  Spans are appended under a lock; offload
   workers, the ai bridge loop, and the engine loop all record
   concurrently.

Enable with ``with obs.tracing() as trz:`` or the ``POPPY_TRACE``
environment variable (``POPPY_TRACE=1`` records; ``POPPY_TRACE=out.json``
additionally writes a Chrome/Perfetto trace at process exit).
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, ContextManager

__all__ = [
    "Span", "Tracer", "tracing", "current_tracer", "current_span",
    "maybe_span",
]

#: Diagnostic counter of Span allocations (all tracers, process-wide).
#: Exists so the disabled-fast-path test can assert a traced-off run
#: allocates exactly zero spans.
SPAN_ALLOCS = 0

#: Phase spans (arg-dependency waits, lock-chain waits, classification)
#: shorter than this are elided via the :meth:`Tracer.record` pattern —
#: they carry no attribution signal and would dominate span count on
#: fan-out workloads where most calls never wait.
PHASE_MIN_S = 100e-6


@dataclass(slots=True)
class Span:
    """One recorded interval.  Times are seconds relative to the owning
    tracer's monotonic origin; ``t1 < 0`` means still open."""

    name: str
    cat: str = ""
    t0: float = 0.0
    t1: float = -1.0
    span_id: int = 0
    parent_id: int = 0           # 0 = no parent
    track: str = "main"
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        """Closed duration in seconds (0.0 while open)."""
        return self.t1 - self.t0 if self.t1 >= self.t0 else 0.0

    @property
    def open(self) -> bool:
        return self.t1 < 0


_current_span: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "poppy_obs_span", default=None)

#: Explicit "no parent" marker for ``begin(parent=...)``: a scheduler
#: recording engine-level spans (e.g. decode steps serving many requests)
#: must not inherit whatever request span happens to sit in its context.
DETACHED = Span(name="<detached>", span_id=0)


def current_span() -> Span | None:
    """The innermost span entered via :meth:`Tracer.span` in this context."""
    return _current_span.get()


class Tracer:
    """Thread-safe span recorder with a per-tracer monotonic origin.

    All timestamps are relative to ``origin`` (a ``time.monotonic`` value
    captured at construction); ``epoch`` is the matching wall-clock
    ``time.time`` so traces from different processes can be aligned.
    """

    def __init__(self, name: str = "poppy") -> None:
        self.name = name
        self.origin = time.monotonic()
        self.epoch = time.time()
        self.spans: list[Span] = []
        self.instants: list[Span] = []
        # record path relies on CPython atomicity of list.append and
        # itertools.count.__next__ (offload workers + bridge loop + engine
        # loop record concurrently); the lock only guards snapshot views
        self._lock = threading.Lock()
        self._next_id = itertools.count(1).__next__

    def now(self) -> float:
        """Seconds since this tracer's origin."""
        return time.monotonic() - self.origin

    # -- recording -----------------------------------------------------------

    def begin(self, name: str, *, cat: str = "", track: str = "main",
              parent: Span | None = None, **attrs: Any) -> Span:
        """Open a span.  ``parent`` overrides the context-derived parent
        (used by schedulers recording on behalf of another request)."""
        return self._begin(name, cat, track, parent, attrs)

    def _begin(self, name: str, cat: str, track: str,
               parent: Span | None, attrs: dict[str, Any]) -> Span:
        """``begin`` with the attrs dict taken by reference — the hot
        path (``attrs`` is always a fresh dict at every call site, so no
        defensive copy)."""
        global SPAN_ALLOCS
        if parent is None:
            parent = _current_span.get()
        if track == "main" and parent is not None:
            track = parent.track    # nest on the parent's display lane
        sp = Span(name=name, cat=cat,
                  t0=time.monotonic() - self.origin,
                  span_id=self._next_id(),
                  parent_id=parent.span_id if parent is not None else 0,
                  track=track, attrs=attrs)
        SPAN_ALLOCS += 1
        self.spans.append(sp)
        return sp

    def end(self, span: Span, **attrs: Any) -> Span:
        """Close a span (idempotent: the first ``end`` wins)."""
        if span.t1 < 0:
            span.t1 = time.monotonic() - self.origin
        if attrs:
            span.attrs.update(attrs)
        return span

    def record(self, name: str, t0: float, *, cat: str = "",
               track: str = "main", parent: Span | None = None,
               **attrs: Any) -> Span:
        """Append an already-finished span retroactively: ``t0`` is a
        tracer-relative start time (from :meth:`now`), the end is *now*.

        This is the cheap pattern for *phase* spans that usually take no
        time (argument-dependency waits, lock-chain waits, dynamic
        classification): the instrumentation site notes ``now()`` before
        the phase and calls ``record`` after it only when the elapsed time
        clears a threshold — the common no-wait path costs two clock reads
        and a comparison instead of a span allocation."""
        global SPAN_ALLOCS
        if parent is None:
            parent = _current_span.get()
        if track == "main" and parent is not None:
            track = parent.track
        sp = Span(name=name, cat=cat, t0=t0,
                  t1=time.monotonic() - self.origin,
                  span_id=self._next_id(),
                  parent_id=parent.span_id if parent is not None else 0,
                  track=track, attrs=attrs)
        SPAN_ALLOCS += 1
        self.spans.append(sp)
        return sp

    def event(self, name: str, *, cat: str = "", track: str = "main",
              parent: Span | None = None, **attrs: Any) -> Span:
        """Record an instant (zero-duration) event."""
        global SPAN_ALLOCS
        if parent is None:
            parent = _current_span.get()
        if track == "main" and parent is not None:
            track = parent.track
        t = time.monotonic() - self.origin
        sp = Span(name=name, cat=cat, t0=t, t1=t,
                  span_id=self._next_id(),
                  parent_id=parent.span_id if parent is not None else 0,
                  track=track, attrs=attrs)
        SPAN_ALLOCS += 1
        self.instants.append(sp)
        return sp

    def span(self, name: str, *, cat: str = "", track: str = "main",
             parent: Span | None = None, **attrs: Any) -> "_SpanCtx":
        """Context manager: open a span and make it the context's current
        span (the parent of anything recorded inside — including tasks
        spawned and threads entered from within)."""
        return _SpanCtx(self, name, cat, track, parent, attrs)

    # -- views ---------------------------------------------------------------

    def closed_spans(self) -> list[Span]:
        """Snapshot of finished spans, start-ordered."""
        with self._lock:
            spans = [s for s in self.spans if not s.open]
        spans.sort(key=lambda s: s.t0)
        return spans

    def __len__(self) -> int:
        with self._lock:
            return len(self.spans)


class _SpanCtx:
    """The reusable-per-call context manager behind :meth:`Tracer.span`."""

    __slots__ = ("tracer", "name", "cat", "track", "parent", "attrs",
                 "sp", "_tok")

    def __init__(self, tracer: Tracer, name: str, cat: str, track: str,
                 parent: Span | None, attrs: dict[str, Any]) -> None:
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.parent = parent
        self.attrs = attrs
        self.sp: Span | None = None
        self._tok: contextvars.Token | None = None

    def __enter__(self) -> Span:
        self.sp = self.tracer._begin(self.name, self.cat, self.track,
                                     self.parent, self.attrs)
        self._tok = _current_span.set(self.sp)
        return self.sp

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        assert self.sp is not None and self._tok is not None
        if exc is not None:
            self.sp.attrs.setdefault("error", type(exc).__name__)
        self.tracer.end(self.sp)
        _current_span.reset(self._tok)
        return False


# ---------------------------------------------------------------------------
# enablement


_tracer_var: contextvars.ContextVar[Tracer | None] = contextvars.ContextVar(
    "poppy_obs_tracer", default=None)

#: Raw POPPY_TRACE value, read once at import (the disabled fast path must
#: not touch os.environ per call).
_ENV_SPEC = os.environ.get("POPPY_TRACE", "")
_env_tracer: Tracer | None = None
_env_lock = threading.Lock()


def _get_env_tracer() -> Tracer:
    global _env_tracer
    with _env_lock:
        if _env_tracer is None:
            _env_tracer = Tracer(name="poppy-env")
            spec = _ENV_SPEC
            if spec not in ("", "0", "1", "true", "yes", "on"):
                # POPPY_TRACE=<path>.json: export at interpreter exit
                import atexit

                def _dump(path: str = spec) -> None:
                    from .export import write_chrome_trace
                    assert _env_tracer is not None
                    write_chrome_trace(path, _env_tracer)

                atexit.register(_dump)
        return _env_tracer


def current_tracer() -> Tracer | None:
    """The active tracer, or None when tracing is off (the fast path)."""
    t = _tracer_var.get()
    if t is not None:
        return t
    if _ENV_SPEC and _ENV_SPEC not in ("0", "false", "no", "off"):
        return _get_env_tracer()
    return None


class tracing:
    """Context manager: record spans from everything running in this
    context (and every task/thread it spawns) into one :class:`Tracer`::

        with obs.tracing() as trz:
            app("...")
        print(obs.report(trz).render())
    """

    def __init__(self, tracer: Tracer | None = None,
                 name: str = "poppy") -> None:
        self.tracer = tracer if tracer is not None else Tracer(name)
        self._tok: contextvars.Token | None = None

    def __enter__(self) -> Tracer:
        self._tok = _tracer_var.set(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> bool:
        assert self._tok is not None
        _tracer_var.reset(self._tok)
        return False


#: Shared no-op context manager for the disabled path: ``maybe_span`` must
#: not allocate when tracing is off.
_NULL_CM: ContextManager[None] = contextlib.nullcontext()


def maybe_span(name: str, *, cat: str = "", track: str = "main",
               parent: Span | None = None,
               **attrs: Any) -> ContextManager[Any]:
    """``tracer.span(...)`` when tracing is active, a shared null context
    otherwise.  The instrumentation sites across engine/dispatch/serving
    use this so the disabled path costs one ContextVar read."""
    t = current_tracer()
    if t is None:
        return _NULL_CM
    return t.span(name, cat=cat, track=track, parent=parent, **attrs)
