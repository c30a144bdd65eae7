"""Dispatch-layer micro-batcher (DESIGN.md §5, §2.3).

Coalesces individual backend requests into batched backend calls.  Two
producers feed it:

* the runtime's queue-time batch windows
  (``repro_torch.core.batching``), whose flushes arrive here as
  ``Dispatcher.generate_batch`` / ``embed_batch`` bursts, and
* plain concurrent traffic through a dispatcher configured with
  ``batch=BatchPolicy(...)`` — single ``generate``/``embed`` calls from
  any number of runtimes window here even without engine batching.

Pipeline position: **cache lookups happen per element before batching**
(a cache-hit element never occupies batch capacity and identical misses
coalesce onto one in-flight element), then the coalesced misses form the
batch, and the batch traverses hedge → route → admit → retry as **one**
request — one admission-controller unit, one routed replica, one retry
key.  Per-element failures come back as ``Exception`` entries in the
result list, failing only their element.

Observability: :class:`BatchStats` records the batch-size histogram, the
fill ratio against the configured ``max_batch``, and per-window wait
times.
"""

from __future__ import annotations

import asyncio
import time

from repro_torch.obs.metrics import Histogram, InstrumentAttr, MetricsRegistry
from repro_torch.obs.spans import current_tracer


class BatchPolicy:
    """Micro-batching configuration for a :class:`~.dispatcher.Dispatcher`.

    ``max_batch`` — flush a window at this many elements.
    ``max_wait_s`` — flush a partial window after this long (the window
    opens at its first element; a few milliseconds trades a tiny latency
    bump for much larger batches under concurrent load).
    """

    __slots__ = ("max_batch", "max_wait_s")

    def __init__(self, max_batch: int = 32, max_wait_s: float = 0.004):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s


def make_batch_policy(batch) -> BatchPolicy | None:
    """Accept a BatchPolicy, True (defaults), a kwargs dict, or None."""
    if batch is None or batch is False:
        return None
    if batch is True:
        return BatchPolicy()
    if isinstance(batch, dict):
        return BatchPolicy(**batch)
    if isinstance(batch, BatchPolicy):
        return batch
    raise TypeError(f"batch must be a BatchPolicy, dict, or True; "
                    f"got {batch!r}")


class BatchStats:
    """Per-batch observability: size histogram, fill ratio, window waits.
    A view over a :class:`~repro_torch.obs.metrics.MetricsRegistry` (the owning
    Dispatcher shares its ``DispatchStats.registry`` so every dispatch
    number lives in one place)."""

    batches = InstrumentAttr()      # batched backend requests dispatched
    elements = InstrumentAttr()     # elements carried by those requests

    def __init__(self, max_batch: int | None = None,
                 registry: MetricsRegistry | None = None):
        reg = registry if registry is not None else MetricsRegistry()
        self.registry = reg
        self.max_batch = max_batch
        self._i_batches = reg.counter("batch_batches")
        self._i_elements = reg.counter("batch_elements")
        self.wait: Histogram = reg.histogram(
            "batch_wait_s", maxlen=4096)    # window open → flush

    @property
    def size_hist(self) -> dict[int, int]:
        """Batch-size histogram, a view over the registry's labeled
        ``batch_size`` counter series."""
        return {int(dict(labels)["size"]): c.value
                for labels, c in self.registry.series("batch_size").items()}

    def record_batch(self, size: int):
        self.batches += 1
        self.elements += size
        self.registry.counter("batch_size", size=size).inc()

    def record_wait(self, seconds: float):
        self.wait.add(seconds)

    @property
    def mean_size(self) -> float:
        return self.elements / self.batches if self.batches else 0.0

    @property
    def fill_ratio(self) -> float:
        """Elements carried per unit of configured batch capacity (0 when
        no ``max_batch`` is known — e.g. engine-window bursts through an
        un-batched dispatcher)."""
        if not self.batches or not self.max_batch:
            return 0.0
        return self.elements / (self.batches * self.max_batch)

    def snapshot(self) -> dict:
        return {
            "batches": self.batches,
            "elements": self.elements,
            "mean_size": self.mean_size,
            "fill_ratio": self.fill_ratio,
            "size_hist": dict(sorted(self.size_hist.items())),
            "wait_p50_s": self.wait.p50,
            "wait_p99_s": self.wait.p99,
        }


class _MicroWindow:
    __slots__ = ("group", "payloads", "futs", "t0", "timer", "trz", "span")

    def __init__(self, group, t0):
        self.group = group
        self.payloads: list = []
        self.futs: list[asyncio.Future] = []
        self.t0 = t0
        self.timer = None
        # observability: the window's open→flush interval as a span on the
        # tracer active when the first element arrived
        self.trz = None
        self.span = None


class MicroBatcher:
    """Windows single-element submissions into batched executes.

    ``execute(group, payloads) -> list`` performs one batched backend
    request for a window; ``group`` identifies what may share a batch
    (request kind plus its shared options).  Result entries may be
    ``Exception`` instances — they fail only their element.
    """

    def __init__(self, policy: BatchPolicy, execute, stats: BatchStats):
        self.policy = policy
        self.execute = execute
        self.stats = stats
        self._windows: dict = {}
        self._tasks: set = set()

    async def submit_many(self, group, payloads) -> list:
        """Enqueue a burst of elements for one group and await all their
        results (``Exception`` entries for failed elements).  Elements are
        enqueued synchronously, so a burst ≤ ``max_batch`` lands in one
        window (merged with any concurrent traffic already waiting)."""
        loop = asyncio.get_running_loop()
        futs = [self._enqueue(loop, group, p) for p in payloads]
        return list(await asyncio.gather(*futs, return_exceptions=True))

    def _enqueue(self, loop, group, payload) -> asyncio.Future:
        w = self._windows.get(group)
        if w is None:
            w = self._windows[group] = _MicroWindow(group, time.monotonic())
            w.trz = current_tracer()
            if w.trz is not None:
                w.span = w.trz.begin("batch.window", cat="dispatch.batch",
                                     group=str(w.group[0]))
            w.timer = loop.call_later(self.policy.max_wait_s,
                                      self._flush, w)
        fut = loop.create_future()
        w.payloads.append(payload)
        w.futs.append(fut)
        if len(w.payloads) >= self.policy.max_batch:
            self._flush(w)
        return fut

    def _flush(self, w: _MicroWindow):
        if self._windows.get(w.group) is not w:
            return  # stale timer: already flushed
        del self._windows[w.group]
        if w.timer is not None:
            w.timer.cancel()
        if w.span is not None:
            w.trz.end(w.span, size=len(w.payloads))
        self.stats.record_wait(time.monotonic() - w.t0)
        task = asyncio.get_running_loop().create_task(self._run(w))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _run(self, w: _MicroWindow):
        try:
            results = await self.execute(w.group, w.payloads)
        except asyncio.CancelledError:
            for fut in w.futs:
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as e:
            results = [e] * len(w.futs)
        for fut, r in zip(w.futs, results):
            if fut.done():
                continue
            if isinstance(r, BaseException):
                fut.set_exception(r)
                fut.exception()  # pre-retrieve: waiter may be cancelled
            else:
                fut.set_result(r)
