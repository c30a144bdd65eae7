"""Continuous-batching inference engine over block-paged or contiguous
KV.

Counterpart of ``repro/serving/engine.py``: a fixed decode batch of
``max_slots`` sequences steps together; free slots admit queued requests
through ``Model.prefill``.  Everything is asyncio — PopPy's bursts of
parallel ``llm()`` calls land here and share decode steps.  Two layouts,
chosen by the model as the reference chooses them:

- **paged** (models whose KV can be cut by position: dense/MoE attention with
  unquantized KV): KV lives in a page pool shared by all slots (``[L, P,
  ps, KVH, hd]``); page 0 is scratch, a per-slot page table maps
  positions to pages, the radix trie (:class:`PagedPrefixCache`) shares
  full prefix pages by reference (zero KV copies at admission), and pages
  are allocated eagerly for prompt + max_new at admission, so decode never
  faults.  Prefill is prefix-aware, bucketed and chunked.
- **contiguous**: one ``[.., max_slots, C, ..]`` cache with a slot per
  sequence, stepped through ``Model.decode_step``.  Models whose cache
  cannot be cut by position (``Model.prefix_seq_axes()`` is None:
  hybrid/recurrent, int8-KV and windowed models, with ring buffers and
  recurrent state) admit a request by one exact-length prefill copied
  into its slot.  A model the paged layout serves may opt into this
  layout (``kv_layout="contiguous"``): its prefill is prefix-aware,
  bucketed and chunked over a radix trie of KV segments
  (:class:`PrefixCache`), and each admission splices the prefilled KV
  into its slot.

The reference's jit + buffer donation becomes in-place updates of the
cache tensors, and its jitted decode step one CUDA graph per engine
(:mod:`.decode_graph`): on a CUDA device the first decode step runs
eagerly, the step is captured right after it and replayed from then on;
on the CPU every step runs eagerly over the same static input buffers.
Spans and metrics follow the reference's (:mod:`repro_torch.obs`).  Not
in this slice (the argument raises): ``mesh=``.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.spans import DETACHED, current_tracer, maybe_span

from .decode_graph import DecodeGraph, tensors
from .prefix_cache import (
    PagedPrefixCache,
    PrefixCache,
    tree_concat,
    tree_nbytes,
    tree_pad_to,
    tree_slice,
)
from .sampler import sample_tokens, sample_tokens_batched


@dataclass
class Request:
    prompt_tokens: list
    max_new_tokens: int
    temperature: float = 0.0
    done: asyncio.Future | None = None
    out_tokens: list = field(default_factory=list)
    slot: int = -1
    submitted_at: float = 0.0
    started_at: float = 0.0
    finished_at: float = 0.0
    # the client-side request span and its tracer: the scheduler loop
    # parents its per-request work under it explicitly
    trz: object = None
    span: object = None

    @property
    def abandoned(self) -> bool:
        """The client is gone (cancelled hedge duplicate, dropped call):
        the engine must not spend decode steps on it."""
        return self.done is not None and self.done.done()


@dataclass
class _PrefillTask:
    """A prompt being prefilled, possibly across several chunks.  ``req``
    is None for cache-warm tasks, which compute and insert KV without
    occupying a decode slot."""

    tokens: tuple
    req: Request | None = None
    slot: int = -1
    done: asyncio.Future | None = None     # warm-task completion
    started: bool = False
    matched: int = 0                       # tokens served by the radix cache
    handle: object = None                  # prefix-cache pin
    pinned_in: object = None               # the cache instance pinned
    acc: object = None                     # KV tree covering tokens[:covered]
    covered: int = 0
    last_logits: object = None
    trz: object = None                     # tracer for warm tasks
    span: object = None                    # warm-task span (open until done)
    page_row: list | None = None           # matched + fresh page ids, in order
    fresh_ids: list | None = None          # pages this task allocated itself


class PageAllocator:
    """Free-list allocator over the KV page pool.

    Page 0 is reserved as *scratch*: retired slots' page tables point at
    it, so their masked per-step decode writes land somewhere harmless.
    Every other page is handed out with refcount 1; the radix trie and
    admitted slots take extra refs on shared prefix pages, and a page
    returns to the free list when its last owner drops it.

    Metrics: ``serving_pages_free`` / ``serving_pages_pinned`` gauges and
    ``serving_page_fault`` / ``serving_page_evict`` counters of
    ``metrics``, beside the plain ``page_faults`` / ``page_evicts``."""

    def __init__(self, num_pages: int, page_size: int, *, metrics=None):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages, 0, -1))  # pop() yields 1, 2, ...
        self._refs = np.zeros(num_pages + 1, np.int64)
        self.page_faults = 0
        self.page_evicts = 0
        self._c_fault = metrics.counter("serving_page_fault") \
            if metrics else None
        self._c_evict = metrics.counter("serving_page_evict") \
            if metrics else None
        self._g_free = metrics.gauge("serving_pages_free") \
            if metrics else None
        self._g_pinned = metrics.gauge("serving_pages_pinned") \
            if metrics else None
        if self._g_free is not None:
            self._g_free.set(num_pages)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list | None:
        """n pages at refcount 1, or None (all-or-nothing: a partial grant
        would deadlock admission)."""
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._refs[i] = 1
        self._note_free()
        return ids

    def incref(self, ids) -> None:
        for i in ids:
            assert i != 0 and self._refs[i] > 0, f"incref of dead page {i}"
            self._refs[i] += 1

    def decref(self, ids) -> int:
        """Drop one ref per id; pages reaching 0 return to the free list.
        Returns how many were freed."""
        freed = 0
        for i in ids:
            self._refs[i] -= 1
            assert self._refs[i] >= 0, f"double free of page {i}"
            if self._refs[i] == 0:
                self._free.append(i)
                freed += 1
        if freed:
            self._note_free()
        return freed

    def refcount(self, i: int) -> int:
        return int(self._refs[i])

    def note_fault(self) -> None:
        """Admission found too few free pages and must reclaim or stall."""
        self.page_faults += 1
        if self._c_fault is not None:
            self._c_fault.inc()

    def note_evict(self, n: int) -> None:
        self.page_evicts += n
        if self._c_evict is not None:
            self._c_evict.inc(n)

    def set_pinned(self, n: int) -> None:
        if self._g_pinned is not None:
            self._g_pinned.set(n)

    def _note_free(self) -> None:
        if self._g_free is not None:
            self._g_free.set(len(self._free))


def default_buckets(max_len: int, lo: int = 16) -> tuple:
    """Powers of two from ``lo`` up to (and always including) max_len."""
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class ServingEngine:
    """Continuous batching over a ``repro_torch.models.Model`` on one
    device: paged KV where the model's cache can be cut by position,
    contiguous otherwise or when asked (``kv_layout`` reports which).

    Knobs, as the reference engine's: ``eos_token`` (a slot retires when
    its last token equals it), ``step_sleep`` (seconds the loop yields
    between steps), ``prefix_cache_budget`` (bytes of radix KV to retain;
    0/None disables), ``prefill_chunk`` (tokens per prefill chunk
    interleaved with decode; None = whole prompt), ``prefill_buckets``
    (pad-to lengths of prefix-aware prefill; default powers of two up to
    ``max_len``, on the paged layout multiples of ``page_size``),
    ``idle_quiesce_s`` (idle seconds before the loop returns; the next
    request restarts it), ``page_size`` and ``num_pages`` (default: enough
    for every slot at ``max_len``), ``metrics`` (a
    :class:`~repro_torch.obs.MetricsRegistry`; default a new one) and
    ``name`` (prefixes this engine's trace tracks, ``<name>:decode`` …).
    Exact-length admission ignores the prefix-cache, chunk and bucket
    knobs.  ``mesh=`` (tensor parallelism) raises: not ported yet."""

    def __init__(self, model, params, *, max_slots=8, max_len=256,
                 eos_token=None, step_sleep=0.0,
                 prefix_cache_budget=64 * 1024 * 1024,
                 prefill_chunk=None, prefill_buckets=None,
                 idle_quiesce_s=1.0, page_size=16, num_pages=None,
                 kv_layout=None, metrics=None, mesh=None, name="",
                 device="cuda", seed=0):
        if kv_layout not in (None, "paged", "contiguous"):
            raise ValueError(f"kv_layout must be 'paged' or 'contiguous', "
                             f"got {kv_layout!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: tensor-parallel serving waits for ROADMAP.md §A.11")
        if model.cfg.family == "enc_dec":
            raise NotImplementedError(
                f"{model.cfg.name}: the engine admits token prompts only "
                f"(the reference engine's admission passes "
                f"{{'tokens': prompt}} alone), so an encoder-decoder "
                f"request has no way to carry its encoder frames; run it "
                f"through Model.prefill and Model.decode_step")
        self.device = resolve_device(device)
        for leaf in tensors(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params are on {leaf.device}, the engine "
                                 f"on {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.name = name
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_token = eos_token
        self.step_sleep = step_sleep
        self.idle_quiesce_s = idle_quiesce_s
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.queue: asyncio.Queue[Request] = asyncio.Queue()
        self.active: dict[int, Request] = {}
        self.free_slots = list(range(max_slots))
        self._pending: list[_PrefillTask] = []
        self._warm_waiting: list[_PrefillTask] = []
        self._wake: asyncio.Event | None = None
        self._wake_loop = None
        self._task = None
        self._stop = False
        self.steps = 0
        self.decode_tokens = 0
        self.batch_occupancy: list[int] = []
        self.decode_step_s: list[float] = []
        self.prefill_shapes: set = set()
        # (prefix tokens, padded length) -> padded prefix KV: a fan-out
        # burst shares one matched prefix and pads it once.  KV is a
        # deterministic function of the tokens, so entries never go
        # stale; the cap only bounds memory.
        self._pad_memo: dict = {}
        self._pad_memo_cap = 4
        self.prefill_chunks = 0
        self.prefill_tokens_computed = 0
        self.prefill_tokens_reused = 0
        # KV copied into the decode cache at admission: a paged
        # shared-prefix hit appends page references, so the paged layout
        # keeps this at 0; the contiguous layout copies once per admission
        self.kv_admit_copies = 0
        self.admit_stalls = 0

        # the per-slot decode state: host arrays (numpy views of pinned
        # staging tensors on CUDA) copied each step into static device
        # buffers, the decode step's only inputs
        pin = self.device.type == "cuda"
        self._tokens_host = torch.zeros((max_slots, 1), dtype=torch.int32,
                                        pin_memory=pin)
        self._positions_host = torch.zeros((max_slots,), dtype=torch.int32,
                                           pin_memory=pin)
        self._cur_tokens = self._tokens_host.numpy()
        self._positions = self._positions_host.numpy()
        self._tokens_dev = torch.zeros((max_slots, 1), dtype=torch.int32,
                                       device=self.device)
        self._positions_dev = torch.zeros((max_slots,), dtype=torch.int32,
                                          device=self.device)
        self._graph: DecodeGraph | None = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._wait_pages: list[Request] = []   # admission backpressure

        # prefix-aware prefill needs a cache cut by position; other models
        # keep the exact-length path
        self._seq_axes = model.prefix_seq_axes()
        self._paged = self._seq_axes is not None
        self.kv_layout = "contiguous" if not self._paged \
            else (kv_layout or "paged")
        self.paged_kv = self.kv_layout == "paged"
        if self.paged_kv:
            if page_size < 1 or max_len % page_size:
                raise ValueError(f"max_len {max_len} must be a positive "
                                 f"multiple of page_size {page_size}")
            self._buckets = tuple(sorted(prefill_buckets)) \
                if prefill_buckets \
                else default_buckets(max_len, lo=max(16, page_size))
            bad = [b for b in self._buckets if b % page_size]
            if bad:
                raise ValueError(f"prefill buckets {bad} are not multiples "
                                 f"of page_size {page_size} (finalize "
                                 f"scatters whole pages)")
        elif self._paged:
            self._buckets = tuple(sorted(prefill_buckets)) \
                if prefill_buckets else default_buckets(max_len)
        else:
            self._buckets = ()
        self.prefill_chunk = prefill_chunk if self._paged else None

        if self.paged_kv:
            self._init_paged(page_size, num_pages, prefix_cache_budget)
            return
        self.page_size = None
        self.num_pages = 0
        self.allocator = None
        self.cache = model.init_cache(max_slots, max_len, device=self.device)
        self.prefix_cache = None
        if self._paged:
            # a dense or MoE model's grouped cache is one block kind stacked
            # over its layers: {"k", "v"} [L, max_slots, max_len, KVH, hd],
            # the prefill KV's layout with the batch axis as the slot axis
            self._slot_kv = self.cache["layers"]["b0"]
            assert set(self.cache) == {"layers"} \
                and set(self.cache["layers"]) == {"b0"} \
                and set(self._slot_kv) == set(self._seq_axes), \
                "a prefix-aware model's cache is one stacked block"
            self._empty_prefix = _empty_prefix(self._slot_kv)
            if prefix_cache_budget:
                self.prefix_cache = PrefixCache(self._seq_axes,
                                                prefix_cache_budget)

    def _init_paged(self, page_size, num_pages, prefix_cache_budget):
        """Block-paged KV state: the page pool shared by all slots, the
        radix trie and the per-slot page tables."""
        max_slots, max_len = self.max_slots, self.max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.num_pages = int(num_pages) if num_pages \
            else max_slots * self.pages_per_slot
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")
        self.allocator = PageAllocator(self.num_pages, page_size,
                                       metrics=self.metrics)
        # pool leaves [L, num_pages + 1, page_size, KVH, hd]; page 0 scratch
        self.kv_pages = self.model.init_paged_cache(
            self.num_pages + 1, page_size, device=self.device)
        self._empty_prefix = _empty_prefix(self.kv_pages)
        self._table_host = torch.zeros(
            (max_slots, self.pages_per_slot), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self._page_table = self._table_host.numpy()
        self._table_dev = torch.zeros_like(self._table_host,
                                           device=self.device)
        self._table_dirty = False
        self.table_uploads = 0
        self._slot_pages: dict[int, list] = {}
        self.page_op_shapes: set = set()
        self.cache = None
        if prefix_cache_budget:
            page_bytes = tree_nbytes(self.kv_pages) // (self.num_pages + 1)
            budget_pages = int(prefix_cache_budget // max(1, page_bytes))
            self.prefix_cache = (PagedPrefixCache(self.allocator,
                                                  budget_pages)
                                 if budget_pages > 0 else None)
        else:
            self.prefix_cache = None

    # -- page ops ---------------------------------------------------------------

    def _gather_fn(self, ids):
        """Pages ``ids`` as a contiguous [L, 1, n·ps, ...] prefix view for
        prefix-aware prefill: a transient copy for attention; the slot's
        KV stays in the shared pages."""
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)

        def g(ax, pool):
            t = pool.index_select(ax - 1, idx)
            shp = list(t.shape)
            return t.reshape(shp[:ax - 1] + [1, shp[ax - 1] * shp[ax]]
                             + shp[ax + 1:])
        return {name: g(self._seq_axes[name], pool)
                for name, pool in self.kv_pages.items()}

    def _fill_fn(self, seg, ids):
        """Scatter freshly prefilled KV ``seg`` ([L, 1, n·ps, ...]) into
        pool pages ``ids``, in place.  Padding ids are 0: the scratch page
        absorbs them."""
        n = len(ids)
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for name, pool in self.kv_pages.items():
            ax = self._seq_axes[name]
            s = seg[name]
            shp = list(s.shape)
            pages = s.reshape(shp[:ax - 1] + [n, self.page_size]
                              + shp[ax + 1:])
            pool[(slice(None),) * (ax - 1) + (idx,)] = pages.to(pool.dtype)

    def _splice(self, seg, slot):
        """Write a prefilled [L, 1, S, ...] KV segment into positions [0, S)
        of ``slot`` of the contiguous cache, in place (the reference's
        donated splice)."""
        for name, cur in self._slot_kv.items():
            ax = self._seq_axes[name]
            s = seg[name]
            cur.select(ax - 1, slot).narrow(ax - 1, 0, s.shape[ax]).copy_(
                s.select(ax - 1, 0))

    def _tr(self, track: str) -> str:
        """Trace track name, prefixed when the engine is named (replicas
        share one trace)."""
        return f"{self.name}:{track}" if self.name else track

    # -- client API -----------------------------------------------------------

    def prefix_probe(self, tokens) -> int:
        """Longest radix-cached prefix of ``tokens`` (read-only; 0 when
        prefix caching is disabled)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.probe(tokens)

    async def generate(self, prompt_tokens, *, max_new_tokens=32,
                       temperature=0.0) -> list:
        prompt_tokens = list(prompt_tokens)
        if len(prompt_tokens) >= self.max_len:
            raise ValueError(
                f"prompt of {len(prompt_tokens)} tokens needs at least "
                f"one decode position; engine max_len is {self.max_len}")
        # pages are allocated eagerly for prompt + max_new at admission: a
        # request needing more than the whole pool would stall forever
        total = min(len(prompt_tokens) + max_new_tokens, self.max_len)
        need = -(-total // self.page_size) if self.paged_kv else 0
        if need > self.num_pages:
            raise ValueError(
                f"request needs {need} KV pages ({len(prompt_tokens)} "
                f"prompt + {max_new_tokens} new tokens at page_size "
                f"{self.page_size}) but the pool holds only "
                f"{self.num_pages} pages even with everything evicted — it "
                f"could never be admitted")
        req = Request(prompt_tokens, max_new_tokens, temperature,
                      done=asyncio.get_running_loop().create_future(),
                      submitted_at=time.monotonic())
        trz = current_tracer()
        if trz is None:
            await self.queue.put(req)
            self._wake_event().set()
            self.ensure_running()
            return await req.done
        # the request span covers the whole lifecycle from the client's
        # side; scheduler-side spans attach to it by parent
        req.trz = trz
        with trz.span("request", cat="serving.request",
                      n_prompt=len(prompt_tokens),
                      max_new=max_new_tokens) as sp:
            req.span = sp
            await self.queue.put(req)
            self._wake_event().set()
            self.ensure_running()
            out = await req.done
            sp.attrs["n_out"] = len(out)
            return out

    def _wake_event(self) -> asyncio.Event:
        # the engine outlives test/benchmark loops: one event per loop
        loop = asyncio.get_running_loop()
        if self._wake is None or self._wake_loop is not loop:
            self._wake = asyncio.Event()
            self._wake_loop = loop
        return self._wake

    async def warm_prefix(self, tokens) -> dict | None:
        """Ensure ``tokens`` (a shared prompt prefix; on the paged layout
        aligned down to whole pages) is in the radix cache, prefilling
        the missing tail without occupying a decode slot.  Returns
        ``{"tokens", "computed"}`` or None when prefix caching is off."""
        if self.prefix_cache is None:
            return None
        tokens = tuple(tokens)[: self.max_len - 1]
        if self.paged_kv:
            # only whole pages are shareable: a partial page would be
            # rewritten by its owner's decode
            tokens = tokens[: len(tokens) - len(tokens) % self.page_size]
        if len(tokens) < 2:
            return None
        fut = asyncio.get_running_loop().create_future()
        task = _PrefillTask(tokens=tokens, done=fut)
        trz = current_tracer()
        if trz is not None:
            task.trz = trz
            task.span = trz.begin("warm_prefix", cat="serving.prefix",
                                  tokens=len(tokens))
        self._warm_waiting.append(task)
        self._wake_event().set()
        self.ensure_running()
        try:
            computed = await fut
        finally:
            if task.span is not None:
                trz.end(task.span)
        return {"tokens": len(tokens), "computed": computed}

    def reset_prefix_cache(self):
        """Drop the cached prefixes nobody pins and the padded-prefix
        memo."""
        if self.prefix_cache is not None:
            if self.paged_kv:
                self.prefix_cache.drop_unpinned()
                self._update_page_gauges()
            else:
                # in-flight pins release into the instance they pinned
                self.prefix_cache = PrefixCache(self._seq_axes,
                                                self.prefix_cache.budget)
        self._pad_memo.clear()

    def ensure_running(self):
        if self._task is None or self._task.done():
            self._stop = False
            self._task = asyncio.get_running_loop().create_task(self._loop())
            self._task.add_done_callback(self._on_loop_done)

    def _on_loop_done(self, task):
        if task.cancelled():
            return
        exc = task.exception()
        if exc is None:
            # quiesce raced a submission: restart so nothing strands
            if not self._stop and (not self.queue.empty()
                                   or self._warm_waiting or self._pending
                                   or self._wait_pages):
                self.ensure_running()
            return
        # surface scheduler failures to every waiting client; release
        # prefix-cache pins, page refs and slots so a crash leaks nothing
        for t in self._pending + self._warm_waiting:
            fut = t.done if t.req is None else t.req.done
            if fut is not None and not fut.done():
                fut.set_exception(exc)
            self._release(t)
            if t.req is not None and t.slot >= 0:
                self._free_slot(t.slot)
            elif t.fresh_ids:
                self.allocator.decref(t.fresh_ids)  # starved warm task
        self._pending.clear()
        self._warm_waiting.clear()
        for slot, req in list(self.active.items()):
            if req.done and not req.done.done():
                req.done.set_exception(exc)
            del self.active[slot]
            self._free_slot(slot)
        for req in self._wait_pages:
            if req.done and not req.done.done():
                req.done.set_exception(exc)
        self._wait_pages.clear()
        while not self.queue.empty():
            req = self.queue.get_nowait()
            if req.done and not req.done.done():
                req.done.set_exception(exc)

    async def stop(self):
        self._stop = True
        self._wake_event().set()
        if self._task is not None:
            await self._task

    # -- stats ----------------------------------------------------------------

    @property
    def prefill_compilations(self) -> int:
        """Distinct padded prefill shapes run (the reference's compile
        count; here the set of kernel shapes prefill launched)."""
        return len(self.prefill_shapes)

    @property
    def prefill_shape_bound(self) -> int | None:
        """Ceiling on distinct prefill shapes: every call pads to a
        (prefix-bucket, suffix-bucket) pair.  None on the exact-length
        path."""
        if not self._paged:
            return None
        return (len(self._buckets) + 1) * len(self._buckets)

    @property
    def page_op_shape_bound(self) -> int:
        return 2 * len(self._buckets)

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "max_occupancy": max(self.batch_occupancy, default=0),
            "prefill_compilations": self.prefill_compilations,
            "prefill_shape_bound": self.prefill_shape_bound,
            "prefill_buckets": list(self._buckets),
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefill_tokens_reused": self.prefill_tokens_reused,
            "kv_layout": self.kv_layout,
            "kv_admit_copies": self.kv_admit_copies,
            "prefix_cache": self.prefix_cache.stats()
            if self.prefix_cache is not None else None,
            "decode_graph": self._graph.stats()
            if self._graph is not None else None,
            "paged": False if not self.paged_kv else {
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "pages_free": self.allocator.free_count,
                "page_faults": self.allocator.page_faults,
                "page_evicts": self.allocator.page_evicts,
                "admit_stalls": self.admit_stalls,
                "page_op_shapes": len(self.page_op_shapes),
                "page_op_shape_bound": self.page_op_shape_bound,
                "table_uploads": self.table_uploads,
            },
        }

    # -- prefill --------------------------------------------------------------

    def _bucket(self, n: int, *, allow_zero=False) -> int:
        if allow_zero and n == 0:
            return 0
        for b in self._buckets:
            if n <= b:
                return b
        return n

    @torch.no_grad()
    def _run_prefill(self, seg, prefix_kv, prefix_len, prefix_key=()):
        """Prefill ``seg`` (a prompt suffix) given ``prefix_len`` tokens of
        already-computed KV.  Pads both sides to buckets; returns
        (boundary logits [1,V], suffix KV of exactly len(seg) positions)."""
        L = len(seg)
        Sb = self._bucket(L)
        toks = np.zeros((1, Sb), np.int32)
        toks[0, :L] = seg
        if prefix_kv is None:
            prefix_kv = self._empty_prefix
        Tb = self._bucket(prefix_len, allow_zero=True)
        memo_key = (prefix_key, Tb) if prefix_key else None
        pfx = self._pad_memo.get(memo_key) if memo_key else None
        if pfx is None:
            pfx = tree_pad_to(prefix_kv, self._seq_axes, Tb)
            if memo_key:
                if len(self._pad_memo) >= self._pad_memo_cap:
                    self._pad_memo.pop(next(iter(self._pad_memo)))
                self._pad_memo[memo_key] = pfx
        self.prefill_shapes.add((Tb, Sb))
        logits, cache = self.model.prefill(
            self.params,
            {"tokens": torch.as_tensor(toks, device=self.device)},
            capacity=Sb, prefix=pfx, prefix_len=prefix_len,
            last_index=L - 1)
        self.prefill_chunks += 1
        self.prefill_tokens_computed += L
        if Sb != L:
            cache = tree_slice(cache, self._seq_axes, 0, L)
        return logits, cache

    def _prefill_start(self, task: _PrefillTask) -> bool:
        """First-touch setup for a pending task (paged requests match and
        allocate inside ``_page_admit``, so on the paged layout this sees
        warm tasks only); returns False when a paged warm task can't get
        pages (warming is best-effort, never an error)."""
        task.started = True
        if self.prefix_cache is None:
            return True
        # a request must prefill >= 1 suffix token for its first logits
        limit = len(task.tokens) - (0 if task.req is None else 1)
        if limit <= 0:
            return True
        matched, kv, handle = self.prefix_cache.match_and_pin(
            task.tokens[:limit])
        task.matched = task.covered = matched
        task.handle = handle
        task.pinned_in = self.prefix_cache
        if self.paged_kv:
            mpages = kv  # the paged trie returns page ids, not KV
            n_fresh = (len(task.tokens) - matched) // self.page_size
            fresh = self._alloc_pages(n_fresh)
            if fresh is None:
                return False
            task.fresh_ids = fresh
            task.page_row = list(mpages) + fresh
            task.acc = self._gather_matched(mpages, matched,
                                            task.tokens[:matched]) \
                if matched else None
        else:
            task.acc = kv
        self.prefill_tokens_reused += matched
        sp = task.req.span if task.req is not None else task.span
        if sp is not None:
            sp.attrs["prefix_matched"] = matched
        return True

    def _release(self, task: _PrefillTask):
        # into the instance pinned: reset_prefix_cache may have swapped it
        if task.handle is not None:
            task.pinned_in.release(task.handle)
            task.handle = None

    def _prefill_step(self):
        """Run one prefill chunk for the oldest pending prompt (between
        decode steps: iteration-level scheduling)."""
        task = self._pending[0]
        if task.req is not None and task.req.abandoned:
            self._pending.pop(0)
            self._release(task)
            self._free_slot(task.slot)
            return
        if not task.started and not self._prefill_start(task):
            self._pending.pop(0)
            self._release(task)
            if task.done is not None and not task.done.done():
                task.done.set_result(0)
            return
        n = len(task.tokens)
        if task.covered >= n:  # warm task fully served by the cache
            self._pending.pop(0)
            self._finalize(task)
            return
        chunk = n - task.covered
        if self.prefill_chunk:
            chunk = min(chunk, self.prefill_chunk)
        seg = task.tokens[task.covered:task.covered + chunk]
        trz = task.req.trz if task.req is not None else task.trz
        psp = None
        if trz is not None:
            psp = trz.begin(
                "prefill.chunk", cat="serving.prefill",
                parent=(task.req.span if task.req is not None
                        else task.span),
                track=self._tr(f"slot:{task.slot}" if task.slot >= 0
                               else "prefill"),
                tokens=chunk, covered=task.covered)
        logits, kvseg = self._run_prefill(
            seg, task.acc, task.covered,
            prefix_key=task.tokens[:task.covered])
        if psp is not None:
            trz.end(psp)
        task.acc = kvseg if task.acc is None \
            else tree_concat([task.acc, kvseg], self._seq_axes)
        task.covered += chunk
        task.last_logits = logits
        if task.covered >= n:
            self._pending.pop(0)
            self._finalize(task)

    @torch.no_grad()
    def _finalize(self, task: _PrefillTask):
        """A task's prompt is fully prefilled: publish its KV to the radix
        cache and, for a request, install it in its slot and start
        decoding."""
        if self.paged_kv:
            self._finalize_paged(task)
            return
        if self.prefix_cache is not None and task.covered > task.matched:
            self.prefix_cache.insert(task.tokens[:task.covered], task.acc)
        self._release(task)
        if task.req is None:  # warm task
            if task.done is not None and not task.done.done():
                task.done.set_result(task.covered - task.matched)
            return
        req = task.req
        if req.abandoned:  # cancelled while its chunks ran
            self._free_slot(task.slot)
            return
        self._splice(task.acc, task.slot)
        self.kv_admit_copies += 1
        self._begin_decode(req, task.slot, task.last_logits)

    def _finalize_paged(self, task: _PrefillTask):
        """Scatter freshly computed KV into the task's fresh pages and
        publish the page-aligned prefix to the trie.  Matched pages are
        never written or copied; decode only ever writes the final,
        unshared partial page."""
        ps = self.page_size
        m_pages = task.matched // ps
        if task.covered > task.matched:
            n_fill = -(-task.covered // ps) - m_pages
            nb = self._bucket(task.covered - task.matched) // ps
            seg = tree_slice(task.acc, self._seq_axes, task.matched,
                             task.covered)
            seg = tree_pad_to(seg, self._seq_axes, nb * ps)
            ids = task.page_row[m_pages:m_pages + n_fill] \
                + [0] * (nb - n_fill)
            self.page_op_shapes.add(("fill", nb))
            with maybe_span("page.fill", cat="serving.paging",
                            track=self._tr("paging"), pages=n_fill):
                self._fill_fn(seg, ids)
        if self.prefix_cache is not None:
            aligned = (task.covered // ps) * ps
            if aligned > 0:
                self.prefix_cache.insert(task.tokens[:aligned],
                                         task.page_row[:aligned // ps])
        self._release(task)
        if task.req is None:  # warm task: pages live on via the trie refs
            if task.fresh_ids:
                self.allocator.decref(task.fresh_ids)
            self._update_page_gauges()
            if task.done is not None and not task.done.done():
                task.done.set_result(task.covered - task.matched)
            return
        req = task.req
        if req.abandoned:  # cancelled while its chunks ran
            self._free_slot(task.slot)
            return
        row = task.page_row
        self._page_table[task.slot, :] = 0
        self._page_table[task.slot, :len(row)] = row
        self._table_dirty = True
        self._begin_decode(req, task.slot, task.last_logits)

    def _begin_decode(self, req: Request, slot: int, logits):
        tok = int(self._sample(logits, req)[0])
        req.out_tokens.append(tok)
        self._cur_tokens[slot, 0] = tok
        self._positions[slot] = len(req.prompt_tokens)
        self.active[slot] = req

    def _sample(self, logits, req):
        return sample_tokens(logits, temperature=req.temperature,
                             generator=self._gen)

    # -- scheduler -------------------------------------------------------------

    def _drain_queue(self):
        if self._warm_waiting:
            self._pending.extend(self._warm_waiting)
            self._warm_waiting.clear()
        if self.paged_kv:
            self._drain_queue_paged()
            return
        while self.free_slots and not self.queue.empty():
            req = self.queue.get_nowait()
            if req.abandoned:  # cancelled while queued
                continue
            req.started_at = time.monotonic()
            slot = self.free_slots.pop()
            req.slot = slot
            self._note_admit(req, slot)
            if self._paged:
                self._pending.append(_PrefillTask(
                    tokens=tuple(req.prompt_tokens), req=req, slot=slot))
            else:
                self._admit_exact(req, slot)

    def _note_admit(self, req: Request, slot: int):
        if req.span is not None:
            req.span.attrs["slot"] = slot
            req.span.attrs["queue_s"] = req.started_at - req.submitted_at
            req.trz.event("admit", cat="serving.admit",
                          parent=req.span, track=self._tr(f"slot:{slot}"),
                          slot=slot)

    @torch.no_grad()
    def _admit_exact(self, req: Request, slot: int):
        """Exact-length one-shot prefill into ``slot`` of the contiguous
        cache (models whose state is not positionally sliceable).  The
        prefill's cache has the slot cache's shape (capacity ``max_len``,
        ring buffers at ``min(max_len, window)``) and is copied into the
        slot in place."""
        n = len(req.prompt_tokens)
        self.prefill_shapes.add((0, n))
        self.prefill_tokens_computed += n
        self.prefill_chunks += 1
        logits, pcache = self.model.prefill(
            self.params,
            {"tokens": torch.tensor([req.prompt_tokens], dtype=torch.int32,
                                    device=self.device)},
            capacity=self.max_len)
        _write_slot_cache(self.cache, pcache, slot)
        self.kv_admit_copies += 1
        self._begin_decode(req, slot, logits)

    def _drain_queue_paged(self):
        """Admit in FIFO order under *page* backpressure: a request that
        can't get its pages parks at the head of ``_wait_pages`` and
        admission stops (no overtaking).  Pages free up as decode retires
        slots or the trie evicts; the loop retries every pass."""
        while self.free_slots and (self._wait_pages
                                   or not self.queue.empty()):
            req = self._wait_pages.pop(0) if self._wait_pages \
                else self.queue.get_nowait()
            if req.abandoned:  # cancelled while queued/stalled
                continue
            task = self._page_admit(req)
            if task is None:
                self._wait_pages.insert(0, req)
                return
            req.started_at = time.monotonic()
            self._note_admit(req, task.slot)
            self._pending.append(task)

    def _page_admit(self, req: Request) -> _PrefillTask | None:
        """Match the radix trie, then *eagerly* allocate every page the
        request can ever touch (prompt + max_new, clamped to max_len).  On
        a trie hit the matched page ids go straight into the slot's page
        row — zero KV bytes move."""
        tokens = tuple(req.prompt_tokens)
        n = len(tokens)
        matched, mpages, handle = 0, (), None
        if self.prefix_cache is not None:
            # n-1: >= 1 suffix token must prefill for first-step logits
            matched, mpages, handle = self.prefix_cache.match_and_pin(
                tokens[:n - 1])
        total = min(n + req.max_new_tokens, self.max_len)
        need = -(-total // self.page_size) - matched // self.page_size
        with maybe_span("page.alloc", cat="serving.paging",
                        track=self._tr("paging"),
                        need=need, matched_pages=matched // self.page_size):
            fresh = self._alloc_pages(need)
        if fresh is None:
            if handle is not None:
                self.prefix_cache.release(handle)
            self.admit_stalls += 1
            if req.trz is not None:
                req.trz.event("page.stall", cat="serving.paging",
                              parent=req.span, track=self._tr("paging"),
                              need=need)
            return None
        # the slot takes its own ref on shared pages: the trie may evict
        # its copy of the path while this request still decodes
        self.allocator.incref(mpages)
        row = list(mpages) + fresh
        slot = self.free_slots.pop()
        req.slot = slot
        self._slot_pages[slot] = row
        # the page-table row is NOT installed yet: until _begin_decode the
        # batched decode step still issues a stale-position write for this
        # slot, which must land in the scratch page — installing the row
        # now would let it corrupt a *shared* matched page
        task = _PrefillTask(tokens=tokens, req=req, slot=slot, started=True,
                            matched=matched, handle=handle,
                            pinned_in=self.prefix_cache, page_row=row,
                            fresh_ids=fresh)
        task.covered = matched
        task.acc = self._gather_matched(mpages, matched, tokens[:matched]) \
            if matched else None
        self.prefill_tokens_reused += matched
        self._update_page_gauges()
        if req.span is not None:
            req.span.attrs["prefix_matched"] = matched
        return task

    def _alloc_pages(self, need: int) -> list | None:
        """Allocate ``need`` pages, reclaiming trie LRU leaves on a fault;
        None when even eviction can't cover it (caller stalls)."""
        if need <= 0:
            return []
        a = self.allocator
        if a.free_count < need:
            a.note_fault()
            if self.prefix_cache is not None:
                with maybe_span("page.reclaim", cat="serving.paging",
                                track=self._tr("paging"), need=need):
                    self.prefix_cache.reclaim(need)
        ids = a.alloc(need)
        self._update_page_gauges()
        return ids

    @torch.no_grad()
    def _gather_matched(self, mpages, matched: int, key_tokens):
        """Matched pages as a contiguous prefix view for prefill (bucketed
        and memoized like ``_run_prefill``'s pad path, so a fan-out burst
        gathers its shared prefix once).  The memo holds a copy, so it
        never goes stale when the source pages are later recycled."""
        tb = self._bucket(matched)
        key = (key_tokens, tb)
        pfx = self._pad_memo.get(key)
        if pfx is None:
            nb = tb // self.page_size
            ids = list(mpages) + [0] * (nb - len(mpages))
            self.page_op_shapes.add(("gather", nb))
            with maybe_span("page.gather", cat="serving.paging",
                            track=self._tr("paging"), pages=len(mpages)):
                pfx = self._gather_fn(ids)
            if len(self._pad_memo) >= self._pad_memo_cap:
                self._pad_memo.pop(next(iter(self._pad_memo)))
            self._pad_memo[key] = pfx
        return tree_slice(pfx, self._seq_axes, 0, matched)

    def _free_slot(self, slot: int):
        if self.paged_kv:
            row = self._slot_pages.pop(slot, None)
            if row:
                self.allocator.decref(row)
                self._update_page_gauges()
            self._page_table[slot, :] = 0
            self._table_dirty = True
        self.free_slots.append(slot)

    def _update_page_gauges(self):
        ev = self.prefix_cache.evictable_pages() \
            if self.prefix_cache is not None else 0
        free = self.allocator.free_count
        self.allocator.set_pinned(self.num_pages - free - ev)

    def _finish(self, slot):
        req = self.active.pop(slot)
        req.finished_at = time.monotonic()
        self._free_slot(slot)
        if not req.done.done():
            req.done.set_result(req.out_tokens)

    def _retire_finished(self):
        for slot in list(self.active):
            req = self.active[slot]
            last = req.out_tokens[-1] if req.out_tokens else None
            if (req.abandoned
                    or len(req.out_tokens) >= req.max_new_tokens
                    or (self.eos_token is not None
                        and last == self.eos_token)
                    or int(self._positions[slot]) >= self.max_len - 1):
                self._finish(slot)

    # -- decode ---------------------------------------------------------------

    def _upload_step_inputs(self):
        """Copy the host decode state into the static device inputs: the
        tokens and positions every step, the page table when it changed."""
        self._tokens_dev.copy_(self._tokens_host, non_blocking=True)
        self._positions_dev.copy_(self._positions_host, non_blocking=True)
        if self.paged_kv and self._table_dirty:
            self._table_dev.copy_(self._table_host, non_blocking=True)
            self._table_dirty = False
            self.table_uploads += 1

    def _decode_step(self):
        """One decode step over the static inputs; → logits [max_slots, V].
        The cache or pool is updated in place."""
        if self.paged_kv:
            return self.model.decode_step_paged(
                self.params, self.kv_pages, self._tokens_dev,
                self._positions_dev, self._table_dev)[0]
        return self.model.decode_step(self.params, self.cache,
                                      self._tokens_dev,
                                      self._positions_dev)[0]

    def _step_state(self):
        """Every tensor the decode step reads or writes in place."""
        if self.paged_kv:
            return (self.kv_pages, self._tokens_dev, self._positions_dev,
                    self._table_dev)
        return (self.cache, self._tokens_dev, self._positions_dev)

    @torch.no_grad()
    def _decode_once(self):
        # decode steps serve the whole batch: record them detached on the
        # engine's decode track, on whichever tracer the requests carry
        trz = next((r.trz for r in self.active.values()
                    if r.trz is not None), None)
        dsp = trz.begin("decode.step", cat="serving.decode",
                        parent=DETACHED, track=self._tr("decode"),
                        occupancy=len(self.active)) \
            if trz is not None else None
        t0 = time.perf_counter()
        self._upload_step_inputs()
        logits = self._graph.replay() if self._graph is not None \
            else self._decode_step()
        self.steps += 1
        self.batch_occupancy.append(len(self.active))
        if any(r.temperature > 0.0 for r in self.active.values()):
            temps = np.zeros((self.max_slots,), np.float32)
            for slot, req in self.active.items():
                temps[slot] = req.temperature
            toks = sample_tokens_batched(
                logits, torch.as_tensor(temps, device=self.device),
                generator=self._gen)
        else:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = toks.cpu().numpy()              # host sync: step really done
        self.decode_step_s.append(time.perf_counter() - t0)
        for slot, req in self.active.items():
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.decode_tokens += 1
            self._cur_tokens[slot, 0] = tok
            self._positions[slot] += 1
        if dsp is not None:
            trz.end(dsp)
        if self._graph is None and self.device.type == "cuda":
            # the eager step above was the warm-up (kernel libraries
            # loaded); capture the same step for every later one
            graph = DecodeGraph(self._decode_step, self._step_state)
            graph.capture()
            self._graph = graph

    async def _loop(self):
        while not self._stop:
            self._drain_queue()
            progressed = False
            if self._pending:
                # one prefill chunk between decode steps: a long admit
                # yields to the live batch instead of freezing it
                self._prefill_step()
                progressed = True
            if self.active:
                self._decode_once()
                self._retire_finished()
                progressed = True
            if progressed:
                await asyncio.sleep(self.step_sleep or 0)
                continue
            # idle: sleep until a submission wakes us; quiesce after
            # idle_quiesce_s (restarted on the next request)
            wake = self._wake_event()
            wake.clear()
            if not self.queue.empty() or self._warm_waiting:
                continue
            try:
                await asyncio.wait_for(wake.wait(), self.idle_quiesce_s)
            except asyncio.TimeoutError:
                if self.queue.empty() and not self._warm_waiting \
                        and not self._pending and not self._wait_pages:
                    return


def _empty_prefix(kv):
    """A zero-length prefix of flat KV leaves [L, X, Y, ...]: [L, 1, 0,
    ...]."""
    return {name: leaf.new_zeros((leaf.shape[0], 1, 0) + leaf.shape[3:])
            for name, leaf in kv.items()}


def _write_slot_cache(full, new, slot, ax=0):
    """Copy a one-sequence cache tree ``new`` into batch slot ``slot`` of
    the engine's cache tree ``full``, in place.  The batch axis is 1 for
    the stacked ``layers`` leaves (``[n_groups, max_slots, ...]``) and 0
    for the rest; apart from it the shapes agree, since prefill fills the
    slot cache's capacity."""
    for key, sub in full.items():
        if isinstance(sub, dict):
            _write_slot_cache(sub, new[key], slot,
                              1 if key == "layers" else ax)
            continue
        src = new[key]
        if src.shape[ax] != 1 or src.shape[:ax] + src.shape[ax + 1:] \
                != sub.shape[:ax] + sub.shape[ax + 1:]:
            raise ValueError(f"cache leaf {key!r}: {tuple(src.shape)} does "
                             f"not fit a slot of {tuple(sub.shape)}")
        sub.select(ax, slot).copy_(src.select(ax, 0))

