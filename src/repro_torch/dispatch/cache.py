"""Deterministic result cache with in-flight coalescing (DESIGN.md §5).

External calls in the PopPy component library are stateless and (for the
deterministic backends used in benchmarking, and for temperature-0 LLM
decodes generally) pure functions of their request — so identical requests
may share one result.  Two tiers plus coalescing:

* in-memory LRU keyed by a stable request hash,
* optional disk tier (one JSON file per key) surviving process restarts,
* *in-flight coalescing*: identical requests that arrive while the first
  is still outstanding await the same future instead of dispatching again
  — exactly the duplicate-burst shape a PopPy ``@unordered`` fan-out
  produces.

Cache hits are trace-equivalent to misses: the PopPy trace records the
external call's queue/dispatch/resolve events in the *controller* (above
this layer), so serving a result from cache changes latency only, never
the observable event structure — the differential-testing invariant holds
with the cache on or off.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
from collections import OrderedDict
from pathlib import Path

from repro_torch.obs.spans import current_tracer, maybe_span


def request_key(kind: str, payload) -> str:
    """Stable hash of an external request.

    ``payload`` must be built from primitives (str/int/float/bool/None and
    tuples thereof) — true for every request the component library emits.
    """
    blob = repr((kind, payload)).encode()
    return hashlib.sha256(blob).hexdigest()


_MISS = object()
#: Public sentinel for cache lookups that found nothing (the batched
#: dispatch pipeline probes the tiers directly for per-element lookups).
MISS = _MISS

_CORRUPT = object()
#: Sentinel for a disk entry that *exists* but failed to parse (torn
#: write from a crash, bit rot): semantically a miss — the request simply
#: re-dispatches — but distinguished so callers can count it
#: (``DispatchStats.disk_corrupt``).  The bad file is unlinked on read so
#: the next put rebuilds it.
CORRUPT = _CORRUPT


class LRUCache:
    """In-memory LRU over request keys."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._d: OrderedDict[str, object] = OrderedDict()

    def get(self, key: str):
        if key not in self._d:
            return _MISS
        self._d.move_to_end(key)
        return self._d[key]

    def put(self, key: str, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)


# -- JSON codec preserving the component library's value types --------------
# llm() returns str; embed() returns tuple(float).  JSON has no tuple, so
# tuples are tagged on the way in and restored on the way out.


def _encode(v):
    if isinstance(v, tuple):
        return {"__tuple__": [_encode(x) for x in v]}
    if isinstance(v, list):
        return [_encode(x) for x in v]
    return v


def _decode(v):
    if isinstance(v, dict) and "__tuple__" in v:
        return tuple(_decode(x) for x in v["__tuple__"])
    if isinstance(v, list):
        return [_decode(x) for x in v]
    return v


class DiskCache:
    """One JSON file per key under ``root`` — a warm tier that outlives the
    process (benchmark re-runs, rolling server restarts)."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def get(self, key: str):
        p = self._path(key)
        try:
            text = p.read_text()
        except OSError:
            return _MISS
        try:
            return _decode(json.loads(text)["value"])
        except (ValueError, KeyError, TypeError):
            # entry exists but doesn't parse (torn write, bit rot): drop
            # the bad file so the next put rebuilds it, and report
            # CORRUPT so callers can count the event — it is otherwise
            # treated exactly like a miss
            try:
                p.unlink()
            except OSError:
                pass
            return _CORRUPT

    def put(self, key: str, value):
        tmp = self._path(key).with_suffix(".tmp")
        tmp.write_text(json.dumps({"value": _encode(value)}))
        tmp.replace(self._path(key))


class ResultCache:
    """LRU + optional disk tier + in-flight request coalescing.

    The in-flight protocol is exposed as ``claim`` / ``settle`` / ``join``
    so the batched dispatch pipeline (``dispatcher._batch_pipeline``) can
    run it per element without duplicating the cancellation-sensitive
    parts; ``get_or_dispatch`` is the single-request composition of the
    same primitives.
    """

    def __init__(self, capacity: int = 4096, disk_dir=None):
        self.mem = LRUCache(capacity)
        self.disk = DiskCache(disk_dir) if disk_dir is not None else None
        self.inflight: dict[str, asyncio.Future] = {}

    # -- in-flight coalescing primitives -----------------------------------

    def claim(self, key: str):
        """Claim the primary dispatch slot for ``key``.  Returns
        ``(fut, is_primary)``: the primary must eventually :meth:`settle`
        the future; a non-primary caller :meth:`join`\\ s it instead."""
        fut = self.inflight.get(key)
        if fut is not None:
            return fut, False
        fut = asyncio.get_running_loop().create_future()
        self.inflight[key] = fut
        return fut, True

    def settle(self, key: str, fut: asyncio.Future, result=None, exc=None):
        """Resolve a claimed primary: release the in-flight slot, fill the
        memory tier on success, and deliver to coalesced waiters.  (The
        disk tier is written by the caller, off the event loop.)"""
        self.inflight.pop(key, None)
        if exc is not None:
            if not fut.done():
                if isinstance(exc, asyncio.CancelledError):
                    fut.cancel()
                else:
                    fut.set_exception(exc)
                    # waiters may or may not exist; don't warn about
                    # unretrieved exceptions for the no-waiter case
                    fut.exception()
            return
        self.mem.put(key, result)
        if not fut.done():
            fut.set_result(result)

    async def join(self, fut: asyncio.Future, redispatch):
        """Await another caller's in-flight dispatch.  Shielded: this
        waiter being cancelled must not cancel the shared dispatch; if the
        *primary* was cancelled instead, the request is still live, so
        ``redispatch`` (an async 0-arg callable) runs it afresh."""
        try:
            return await asyncio.shield(fut)
        except asyncio.CancelledError:
            if fut.cancelled():
                return await redispatch()
            raise

    # -- single-request pipeline -------------------------------------------

    async def get_or_dispatch(self, key: str, thunk, stats=None):
        """Return the cached value for ``key``, or run ``thunk`` (an async
        0-arg callable) exactly once per concurrent burst and share it."""
        trz = current_tracer()
        v = self.mem.get(key)
        if v is not _MISS:
            if stats is not None:
                stats.cache_hits += 1
            if trz is not None:
                trz.event("cache.hit", cat="dispatch.cache")
            return v
        if self.disk is not None:
            # disk I/O off the event loop: a slow filesystem must not stall
            # every other in-flight request / admission waiter / hedge timer
            with maybe_span("cache.disk", cat="dispatch.cache"):
                v = await asyncio.to_thread(self.disk.get, key)
            if v is _CORRUPT:
                if stats is not None:
                    stats.disk_corrupt += 1
                if trz is not None:
                    trz.event("cache.disk_corrupt", cat="dispatch.cache")
                v = _MISS
            if v is not _MISS:
                self.mem.put(key, v)
                if stats is not None:
                    stats.cache_hits += 1
                    stats.disk_hits += 1
                if trz is not None:
                    trz.event("cache.disk_hit", cat="dispatch.cache")
                return v
        fut, primary = self.claim(key)
        if not primary:
            if stats is not None:
                stats.coalesced += 1
            with maybe_span("cache.join", cat="dispatch.cache"):
                return await self.join(
                    fut, lambda: self.get_or_dispatch(key, thunk, stats))
        if stats is not None:
            stats.cache_misses += 1
        try:
            value = await thunk()
        except BaseException as e:
            self.settle(key, fut, exc=e)
            raise
        self.settle(key, fut, result=value)
        if self.disk is not None:
            await asyncio.to_thread(self.disk.put, key, value)
        return value

    def store(self, key: str, value):
        self.mem.put(key, value)
        if self.disk is not None:
            self.disk.put(key, value)


def make_cache(cache) -> ResultCache | None:
    """Accept a ResultCache, True (defaults), a kwargs dict, or None."""
    if cache is None or cache is False:
        return None
    if cache is True:
        return ResultCache()
    if isinstance(cache, dict):
        return ResultCache(**cache)
    return cache
