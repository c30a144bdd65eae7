"""Engine-side batch windows (DESIGN.md §2.3).

The opportunistic engine exposes *which* external calls are concurrently
pending; this module exploits it.  When several **unordered** calls to the
same ``batchable=`` component become dispatch-ready together (a fan-out
loop, a map step), the runtime parks them in a *batch window* keyed by
``(component, batch key)`` instead of firing them one-by-one, then flushes
the window as **one** batched backend request and scatters the per-element
results back to the calls' placeholders.

Soundness: only unordered calls batch, so ≡_A is untouched — the batched
run's trace records exactly the same per-call queue/dispatch/resolve
events (one per element), and unordered events compare as a multiset.
Error isolation is per element: the handler may return an ``Exception``
for one element, which fails only that call's placeholder (the program
then fails exactly where sequential Python would have raised).

Flush policy — a window flushes at the earliest of:

* **full** — ``max_batch`` elements collected;
* **quiesce** — the event loop drained without a new submission: nothing
  more can join the window until some outstanding external resolves, so
  waiting longer would only add latency.  This is what lets a window
  smaller than ``max_batch`` flush immediately at end of program instead
  of hanging until the deadline;
* **deadline** — ``max_wait_ms`` elapsed (a backstop; quiesce almost
  always wins).

Batching is off by default (zero behavior change); enable it per scope
with ``with batching(): app()``.  ``sequential_mode()`` bypasses the
engine entirely and ``force_sequential_annotations()`` classifies every
call sequential, so both disable batching by construction.
"""

from __future__ import annotations

import asyncio
import contextvars
from dataclasses import dataclass

from . import registry
from .errors import ExternalCallError
from .trace import safe_repr


@dataclass(frozen=True)
class BatchingPolicy:
    """Runtime-wide auto-batching configuration.  ``enabled`` turns the
    queue-time batch windows on for components declaring ``batchable=``."""

    enabled: bool = False


_batching_policy: contextvars.ContextVar[BatchingPolicy] = \
    contextvars.ContextVar("poppy_batching_policy",
                           default=BatchingPolicy())


def current_batching_policy() -> BatchingPolicy:
    return _batching_policy.get()


class batching:
    """Context manager: enable (or disable) auto-batching of pending
    unordered calls to ``batchable=`` components for runtimes started in
    this context::

        with batching():
            app()              # concurrent llm()/embed() calls coalesce
    """

    def __init__(self, enabled: bool = True):
        self.policy = BatchingPolicy(enabled=bool(enabled))

    def __enter__(self):
        self._tok = _batching_policy.set(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _batching_policy.reset(self._tok)
        return False


class _Window:
    """One open batch window: the calls collected so far for one
    ``(component, batch key)`` pair."""

    __slots__ = ("wkey", "fn", "spec", "items", "timer", "ctx")

    def __init__(self, wkey, fn, spec):
        self.wkey = wkey
        self.fn = fn
        self.spec = spec
        self.items = []     # (pos, kw, fut, ev)
        self.timer = None   # max_wait_ms backstop handle
        self.ctx = None     # first submitter's context (ambient dispatcher)


class BatchCollector:
    """Per-runtime owner of the open batch windows.

    Quiesce detection: submissions only ever happen from controller tasks
    running on the engine's event loop, and every path that could produce
    one is itself scheduled through the loop's ready queue.  The collector
    arms a ``call_soon`` probe after each submission; the probe re-arms
    while new submissions keep arriving and flushes every open window after
    two consecutive passes of the ready queue produced none — at that point
    the loop is quiescent and no call can join a window until some
    outstanding external resolves (at which point a *new* window opens,
    which is the intended opportunistic behavior).
    """

    def __init__(self, rt):
        self.rt = rt
        self.windows: dict = {}
        self._probe_armed = False
        self._version = 0
        self._closed = False

    # -- submission ---------------------------------------------------------

    async def submit(self, fn, spec, key, pos, kw, ev):
        """Park one dispatch-ready unordered call in its window; resolves
        with this call's element result once the window's batch lands."""
        rt = self.rt
        wkey = (id(getattr(fn, "__poppy_external__", None) or fn), key)
        w = self.windows.get(wkey)
        if w is None:
            w = self.windows[wkey] = _Window(wkey, fn, spec)
            w.ctx = contextvars.copy_context()
            if spec.max_wait_ms is not None:
                w.timer = rt.loop.call_later(
                    spec.max_wait_ms / 1000.0, self._flush, w)
        fut = rt.new_future()
        w.items.append((pos, kw, fut, ev))
        self._version += 1
        if len(w.items) >= spec.max_batch:
            self._flush(w)
        else:
            self._arm_probe()
        return await fut

    # -- quiesce probe ------------------------------------------------------

    def _arm_probe(self):
        if self._probe_armed or self._closed:
            return
        self._probe_armed = True
        self.rt.loop.call_soon(self._probe, self._version, 0)

    def _probe(self, seen_version, quiet_passes):
        self._probe_armed = False
        if self._closed or not self.windows:
            return
        if self._version != seen_version:
            # new submissions arrived this pass: keep collecting
            self._probe_armed = True
            self.rt.loop.call_soon(self._probe, self._version, 0)
            return
        if quiet_passes + 1 < 2:
            self._probe_armed = True
            self.rt.loop.call_soon(self._probe, self._version,
                                   quiet_passes + 1)
            return
        for w in list(self.windows.values()):
            self._flush(w)

    # -- flushing -----------------------------------------------------------

    def _flush(self, w: _Window):
        if self.windows.get(w.wkey) is not w:
            return  # stale timer: already flushed
        del self.windows[w.wkey]
        if w.timer is not None:
            w.timer.cancel()
        # spawn in the first submitter's context so ambient state (the
        # dispatcher, backend, trace) resolves as at the call sites
        w.ctx.run(self.rt.spawn, self._run_batch(w))

    async def _run_batch(self, w: _Window):
        rt = self.rt
        items = w.items
        if rt.error is not None:
            raise asyncio.CancelledError  # run is aborting; don't dispatch
        name = registry.callable_name(w.fn)
        if rt.trace is not None:
            for pos, kw, _, ev in items:
                if ev is not None:
                    rt.trace.dispatched(
                        ev, args_repr=safe_repr((tuple(pos), kw)))
        calls = [(tuple(pos), dict(kw)) for pos, kw, _, _ in items]
        try:
            results = await w.spec.handler(calls)
            if not isinstance(results, (list, tuple)) \
                    or len(results) != len(items):
                raise TypeError(
                    f"batch handler for {name} returned "
                    f"{type(results).__name__} of length "
                    f"{len(results) if isinstance(results, (list, tuple)) else 'n/a'}, "
                    f"expected {len(items)} results")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            err = ExternalCallError(name, e)
            err.__cause__ = e  # as if raised with ``from e``
            for _, _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(err)
                    fut.exception()  # pre-retrieve: waiter may be cancelled
            return
        info = getattr(w.fn, "__poppy_external__", None)
        for (pos, kw, fut, ev), r in zip(items, results):
            if isinstance(r, BaseException):
                if isinstance(r, ExternalCallError):
                    exc = r
                else:
                    exc = ExternalCallError(name, r)
                    exc.__cause__ = r  # as if raised with ``from r``
                if not fut.done():
                    fut.set_exception(exc)
                    fut.exception()
                continue
            if rt.trace is not None and ev is not None:
                rt.trace.resolved(ev)
                if info is not None and info.effects is not None:
                    effs = registry.effect_keys(info, pos, kw)
                    if effs is not None:
                        rt.trace.set_effects(ev, effs)
            if not fut.done():
                fut.set_result(r)

    # -- teardown -----------------------------------------------------------

    def close(self):
        """Abort-path cleanup: cancel backstop timers so nothing fires into
        a closing loop.  Un-flushed element futures stay unset — their
        awaiting controllers are being cancelled by the runtime."""
        self._closed = True
        for w in self.windows.values():
            if w.timer is not None:
                w.timer.cancel()
        self.windows.clear()
