"""PopPy AI component library (paper §6.1); the port's copy of
``repro/core/ai.py``.

Annotated, asynchronous clients for the external components compound-AI
applications call: LLMs, text-embedding models, and a generic async HTTP
method for arbitrary stateless remote APIs.  All are ``@unordered`` —
stateless remote requests — so the opportunistic engine dispatches them the
moment their prompts are ready, which is where the end-to-end speedups come
from.

Backends
--------
* ``LocalEngineBackend`` (``repro_torch.serving.backend``) — a model served
  by the port's continuous-batching engine on the card; PopPy's burst of
  parallel calls share decode batches (DESIGN.md §3).
* ``SimulatedBackend`` — deterministic latency-modeled responses, bound
  explicitly (tests, benchmarks).  Unlike the reference, :func:`get_backend`
  never falls back to it: with nothing bound it raises, so a program can
  not silently get fake answers instead of the card's.

Every call routes through a ``repro_torch.dispatch.Dispatcher``
(multi-backend routing, admission control, caching, retries, hedging —
DESIGN.md §5); the default dispatcher is trivial and byte-identical to
calling the ambient backend directly.  Install a configured one with
``use_dispatcher``.  The port's ``Dispatcher`` binds itself here while it
calls a backend, so :func:`ambient_dispatch_stats` inside a backend
resolves to the dispatcher that routed the call.
"""

from __future__ import annotations

import asyncio
import contextvars
import hashlib
import inspect
import math
import threading
from dataclasses import dataclass, field

from . import registry
from .annotations import batch_handler, readonly, sequential, unordered
from .errors import FirstSuccessError
from .values import is_pending, peek
from ..obs.spans import maybe_span


class Backend:
    """Interface for LLM/embedding backends.

    The batch methods accept list payloads and return one result per
    element *in order*; an entry may be an ``Exception`` instance, failing
    only that element.  The defaults fan a batch out to the single-call
    methods concurrently — a backend with true server-side batching (one
    admission per batch) overrides them.
    """

    async def generate(self, prompt: str, *, max_tokens: int,
                       temperature: float, stop) -> str:
        raise NotImplementedError

    async def embed(self, text: str) -> tuple:
        raise NotImplementedError

    async def generate_batch(self, prompts, *, max_tokens: int,
                             temperature: float, stop) -> list:
        return list(await asyncio.gather(
            *(self.generate(p, max_tokens=max_tokens,
                            temperature=temperature, stop=stop)
              for p in prompts),
            return_exceptions=True))

    async def embed_batch(self, texts) -> list:
        return list(await asyncio.gather(
            *(self.embed(t) for t in texts), return_exceptions=True))


@dataclass
class SimulatedBackend(Backend):
    """Deterministic latency-modeled LLM.

    latency = base + per_prompt_char · len(prompt) + per_token · n_tokens,
    with a deterministic per-prompt jitter of ±jitter_frac drawn from the
    prompt hash.  Responses are a deterministic function of the prompt so
    PopPy and plain-Python runs are comparable call-for-call.
    """

    base_s: float = 0.02
    per_prompt_char_s: float = 0.0
    per_token_s: float = 0.002
    jitter_frac: float = 0.3
    vocab: tuple = ("alpha", "beta", "gamma", "delta", "epsilon", "zeta",
                    "eta", "theta", "iota", "kappa")
    # observability for tests/benchmarks
    calls: list = field(default_factory=list)
    max_in_flight: int = 0
    _in_flight: int = 0
    time_scale: float = 1.0
    responder: object = None   # optional callable(prompt, max_tokens) -> str
    # list-payload (batched) requests: one request carries n elements in
    # max(element latencies) + per_batch_item_s·n — the server-side batching
    # profile.  ``batches`` records each batched request's element count.
    per_batch_item_s: float = 0.0
    batches: list = field(default_factory=list)

    def _digest(self, prompt: str) -> int:
        return int.from_bytes(
            hashlib.sha256(prompt.encode()).digest()[:8], "big")

    def latency(self, prompt: str, n_tokens: int) -> float:
        d = self._digest(prompt)
        jitter = 1.0 + self.jitter_frac * (((d >> 8) % 1000) / 500.0 - 1.0)
        lat = (self.base_s + self.per_prompt_char_s * len(prompt)
               + self.per_token_s * n_tokens) * jitter
        return lat * self.time_scale

    def response(self, prompt: str, max_tokens: int) -> str:
        if self.responder is not None:
            return self.responder(prompt, max_tokens)
        d = self._digest(prompt)
        n = min(max_tokens, 1 + d % 7)
        words = [self.vocab[(d >> (4 * i)) % len(self.vocab)]
                 for i in range(n)]
        return " ".join(words)

    # counter updates are lock-protected: with sync clients the backend is
    # driven from the bridge loop's thread concurrently with the engine loop
    _count_lock: threading.Lock = field(default_factory=threading.Lock,
                                        repr=False)

    def _enter(self, key):
        with self._count_lock:
            self._in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self._in_flight)
            self.calls.append(key)

    def _exit(self):
        with self._count_lock:
            self._in_flight -= 1

    async def generate(self, prompt, *, max_tokens, temperature, stop):
        n_out = min(max_tokens, 1 + self._digest(prompt) % 7)
        self._enter(prompt)
        try:
            await asyncio.sleep(self.latency(prompt, n_out))
        finally:
            self._exit()
        return self.response(prompt, max_tokens)

    async def embed(self, text):
        self._enter(text)
        try:
            await asyncio.sleep(self.base_s * self.time_scale)
        finally:
            self._exit()
        return self._embedding(text)

    def _embedding(self, text) -> tuple:
        d = self._digest(text)
        return tuple(
            math.sin((d % 997) * (i + 1) / 97.0) for i in range(8))

    # -- list payloads (batched requests) ---------------------------------
    # Responses are element-for-element identical to the single-call
    # methods (a deterministic function of each prompt), so batched and
    # unbatched runs produce byte-identical results.

    async def generate_batch(self, prompts, *, max_tokens, temperature,
                             stop):
        prompts = list(prompts)
        if not prompts:
            return []
        lat = max(self.latency(p, min(max_tokens, 1 + self._digest(p) % 7))
                  for p in prompts)
        lat += self.per_batch_item_s * self.time_scale * len(prompts)
        with self._count_lock:
            self.batches.append(len(prompts))
        for p in prompts:
            self._enter(p)
        try:
            await asyncio.sleep(lat)
        finally:
            for _ in prompts:
                self._exit()
        return [self.response(p, max_tokens) for p in prompts]

    async def embed_batch(self, texts):
        texts = list(texts)
        if not texts:
            return []
        lat = (self.base_s
               + self.per_batch_item_s * len(texts)) * self.time_scale
        with self._count_lock:
            self.batches.append(len(texts))
        for t in texts:
            self._enter(t)
        try:
            await asyncio.sleep(lat)
        finally:
            for _ in texts:
                self._exit()
        return [self._embedding(t) for t in texts]


_backend: contextvars.ContextVar[Backend | None] = contextvars.ContextVar(
    "repro_torch_ai_backend", default=None)


def set_backend(b: Backend):
    _backend.set(b)


def get_backend() -> Backend:
    b = _backend.get()
    if b is None:
        raise RuntimeError(
            "no backend bound: bind one with use_backend() or set_backend() "
            "(the port has no simulated fallback model)")
    return b


class use_backend:
    """Context manager binding the ambient LLM/embed backend."""

    def __init__(self, b: Backend):
        self.b = b

    def __enter__(self):
        self._tok = _backend.set(self.b)
        return self.b

    def __exit__(self, *exc):
        _backend.reset(self._tok)
        return False


# ---------------------------------------------------------------------------
# dispatch layer (repro_torch.dispatch)
#
# Every component call routes through a Dispatcher — multi-backend routing,
# admission control, result caching, retries, hedging (DESIGN.md §5).  The
# default is the *trivial* dispatcher: a single logical replica resolving
# the ambient `use_backend` backend per call, with every production feature
# off — byte-identical to calling the backend directly, so existing code
# and the differential-testing baseline see zero behavior change.

_dispatcher: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ai_dispatcher", default=None)
_default_dispatcher = None


def set_dispatcher(d):
    _dispatcher.set(d)


def get_dispatcher():
    d = _dispatcher.get()
    if d is not None:
        return d
    # module-level (not contextvar) default: get_dispatcher() may first run
    # inside a controller task whose context copy would discard the set()
    global _default_dispatcher
    if _default_dispatcher is None:
        from repro_torch.dispatch import Dispatcher
        _default_dispatcher = Dispatcher()
    return _default_dispatcher


def ambient_dispatch_stats():
    """The ``DispatchStats`` of the dispatcher ambient at the call site.
    Backends use this to flow backend-side observations (e.g. the serving
    engine's shared-prefix admission counters) into the same stats
    surface the dispatcher reports — the backend is *called by* the
    dispatcher, which binds itself in this contextvar around the call, so
    it resolves to the dispatcher that routed the call."""
    return get_dispatcher().stats


class use_dispatcher:
    """Route component calls in this context through ``d`` (a
    ``repro_torch.dispatch.Dispatcher``)."""

    def __init__(self, d):
        self.d = d

    def __enter__(self):
        self._tok = _dispatcher.set(self.d)
        return self.d

    def __exit__(self, *exc):
        _dispatcher.reset(self._tok)
        return False


# ---------------------------------------------------------------------------
# annotated external components
#
# llm/embed declare ``batchable=``: under ``repro_torch.core.batching`` the
# engine coalesces concurrently pending calls that share decode options
# and the ambient dispatcher into one list-payload dispatcher request
# (DESIGN.md §2.3).  Batching is off by default — the declarations alone
# change nothing.


def _llm_batch_key(pos, kw):
    # only calls sharing decode options and the same dispatcher may share
    # a backend request (an unhashable ``stop`` opts the call out)
    return (kw.get("max_tokens", 64), kw.get("temperature", 0.0),
            kw.get("stop", None), id(get_dispatcher()))


def _embed_batch_key(pos, kw):
    return (id(get_dispatcher()),)


@unordered(returns_immutable=True, batchable=(64, 25.0, _llm_batch_key))
async def llm(prompt: str, *, max_tokens: int = 64, temperature: float = 0.0,
              stop=None) -> str:
    """Stateless LLM completion — @unordered: dispatches the moment the
    prompt is ready, in parallel with anything else in flight."""
    return await get_dispatcher().generate(
        prompt, max_tokens=max_tokens, temperature=temperature, stop=stop)


@batch_handler(llm)
async def _llm_batch(calls):
    _, kw0 = calls[0]
    prompts = [pos[0] if pos else kw.get("prompt") for pos, kw in calls]
    return await get_dispatcher().generate_batch(
        prompts, max_tokens=kw0.get("max_tokens", 64),
        temperature=kw0.get("temperature", 0.0), stop=kw0.get("stop", None))


@unordered(returns_immutable=True, batchable=(128, 25.0, _embed_batch_key))
async def embed(text: str) -> tuple:
    """Text-embedding model call."""
    return await get_dispatcher().embed(text)


@batch_handler(embed)
async def _embed_batch(calls):
    texts = [pos[0] if pos else kw.get("text") for pos, kw in calls]
    return await get_dispatcher().embed_batch(texts)


def _url_host(url) -> str:
    """Scheme-agnostic host extraction (no urllib import on the hot path)."""
    s = str(url)
    rest = s.split("://", 1)[1] if "://" in s else s
    return rest.split("/", 1)[0].split("?", 1)[0] or "unknown"


def _http_effects(args, kwargs):
    url = peek(args[0] if args else kwargs.get("url"))
    if url is None or is_pending(url):
        return None
    return (f"http:{_url_host(url)}",)


@unordered(effects=_http_effects, returns_immutable=True)
async def http(url: str, payload=None) -> str:
    """Generic asynchronous HTTP method for arbitrary stateless remote APIs
    (GETs — @unordered).  Declares a per-host effect domain for
    observability (per-domain trace/dispatch stats); being unordered it
    imposes no ordering regardless.  Served, like ``llm``, by the backend
    the ambient dispatcher routes to, keyed on the URL and payload."""
    keys = _http_effects([url], {}) or ()
    return await get_dispatcher().generate(
        f"{url}::{payload}", max_tokens=32, temperature=0.0, stop=None,
        domains=keys)


@sequential(effects=_http_effects, returns_immutable=True)
async def http_post(url: str, payload=None) -> str:
    """Mutating HTTP call (POST/PUT — @sequential), ordered *per host*:
    posts to distinct hosts overlap, posts to one host keep program order.
    Served by the backend the ambient dispatcher routes to."""
    keys = _http_effects([url], {}) or ()
    return await get_dispatcher().generate(
        f"POST {url}::{payload}", max_tokens=32, temperature=0.0, stop=None,
        domains=keys)


# ---------------------------------------------------------------------------
# session-keyed memory
#
# The canonical *stateful* component of compound-AI apps: per-session
# conversation/agent memory.  Reads are @readonly and writes @sequential —
# but keyed to the session's effect domain (DESIGN.md §2.2), so two
# agents' memories never serialize against each other while one agent's
# history keeps strict program order.


class MemoryStore:
    """Session-keyed memory with effect-domain-annotated accessors.

    ``append(session, text)`` is ``@sequential(effects=("<name>:{session}",))``
    and ``read(session)`` / ``size(session)`` are ``@readonly`` on the same
    domain: within one session, reads see every preceding append and
    appends keep program order; across sessions, everything overlaps.

    Accessors run inline (``offload="inline"``) — they are dict operations,
    not I/O.  ``name`` namespaces the effect domain (default ``"memory"``),
    so two stores with different names are independent even for equal
    session ids.
    """

    def __init__(self, name: str = "memory"):
        self.name = name
        self._data: dict = {}
        store = self
        dom = (f"{name}:{{session}}",)

        @sequential(effects=dom, offload="inline", returns_immutable=True)
        def append(session, text):
            store._data.setdefault(session, []).append(text)
            return None

        @readonly(effects=dom, offload="inline", returns_immutable=True)
        def read(session):
            return tuple(store._data.get(session, ()))

        @readonly(effects=dom, offload="inline", returns_immutable=True)
        def size(session):
            return len(store._data.get(session, ()))

        for f, label in ((append, "append"), (read, "read"), (size, "size")):
            f.__name__ = f.__qualname__ = f"{name}.{label}"
            f.__poppy_external__.name = f"{name}.{label}"
        self.append = append
        self.read = read
        self.size = size

    def sessions(self) -> tuple:
        return tuple(sorted(self._data))

    def snapshot(self) -> dict:
        return {k: tuple(v) for k, v in self._data.items()}

    def clear(self):
        self._data.clear()


# ---------------------------------------------------------------------------
# blocking (sync-SDK) components
#
# The dominant real-world client is *synchronous* — classic ``openai``,
# ``requests``.  These components model that case: they block their calling
# thread until the response arrives.  Under the opportunistic engine they
# are dispatched on the runtime's offload executor (engine.OffloadPolicy),
# so N independent blocking calls overlap N-way; under standard sequential
# Python they simply block, the paper's baseline.
#
# Internally each blocking call drives the ambient async Dispatcher on a
# single shared *bridge* event loop owned by a daemon thread.  One loop for
# all worker threads keeps the dispatcher's loop-bound state (admission
# semaphores, coalescing futures, hedge tasks) on one loop — the
# thread-safe path from any worker thread into ``repro_torch.dispatch``.
#
# Restriction: a *configured* dispatcher with loop-bound state (admission
# ``max_concurrency``, caching) must be driven from one loop only — use
# either the async components (engine loop) or the sync ones (bridge loop)
# with it, not both in the same program.  The trivial/default dispatcher
# and stateless configurations (routing, retries) mix freely.


class _BridgeLoop:
    """Lazily-started daemon thread running the event loop that executes
    dispatcher coroutines on behalf of blocking callers."""

    _singleton = None
    _singleton_lock = threading.Lock()

    def __init__(self):
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self.loop.run_forever, name="poppy-ai-bridge", daemon=True)
        self._thread.start()

    @classmethod
    def get(cls) -> "_BridgeLoop":
        with cls._singleton_lock:
            if cls._singleton is None:
                cls._singleton = cls()
            return cls._singleton

    def run(self, make_coro):
        """Run ``make_coro()`` on the bridge loop, blocking the calling
        thread until it completes.  The caller's context is re-established
        inside the bridge task so ambient state (``use_backend``,
        ``use_dispatcher``, the current trace) resolves as at the call site.
        """
        ctx = contextvars.copy_context()

        async def runner():
            for var in ctx:  # adopt the caller's context, task-locally
                var.set(ctx[var])
            return await make_coro()

        return asyncio.run_coroutine_threadsafe(runner(), self.loop).result()


def run_blocking(make_coro):
    """Drive an async dispatcher call to completion from any thread (the
    sync-client bridge).  Raises if called on a thread whose event loop is
    running — blocking a live loop is the exact serialization bug the
    offload layer exists to avoid."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return _BridgeLoop.get().run(make_coro)
    raise RuntimeError(
        "blocking component called on a running event loop; use the async "
        "component (llm/embed/http) here, or let the engine offload this "
        "call to a worker thread")


@unordered(returns_immutable=True)
def llm_sync(prompt: str, *, max_tokens: int = 64, temperature: float = 0.0,
             stop=None) -> str:
    """Blocking LLM completion (the classic sync-SDK client).  @unordered:
    under the engine it runs on the offload executor, so independent calls
    overlap exactly like their async twins."""
    return run_blocking(lambda: get_dispatcher().generate(
        prompt, max_tokens=max_tokens, temperature=temperature, stop=stop))


@unordered(returns_immutable=True)
def embed_sync(text: str) -> tuple:
    """Blocking text-embedding call."""
    return run_blocking(lambda: get_dispatcher().embed(text))


@unordered(effects=_http_effects, returns_immutable=True)
def http_sync(url: str, payload=None) -> str:
    """Blocking HTTP method (the ``requests`` case)."""
    keys = _http_effects([url], {}) or ()
    return run_blocking(lambda: get_dispatcher().generate(
        f"{url}::{payload}", max_tokens=32, temperature=0.0, stop=None,
        domains=keys))


class use_sync_clients:
    """Swap the async components (``llm``/``embed``/``http``) for their
    blocking twins for the duration of the context — *both* under standard
    sequential Python and under the engine (the annotation wrappers resolve
    their dispatch target per call).

    This is how the benchmarks run an unmodified app in "sync-external"
    mode: same program, same prompts, but every component call blocks its
    thread like a real sync SDK.  Swapping is process-global (it rebinds
    the wrappers' dispatch targets), so don't nest it with concurrent runs
    that need async clients.
    """

    _PAIRS = None  # built lazily: [(async_wrapper, blocking_inner), ...]

    def __enter__(self):
        pairs = use_sync_clients._PAIRS
        if pairs is None:
            pairs = use_sync_clients._PAIRS = [
                (llm, llm_sync.__poppy_dispatch__),
                (embed, embed_sync.__poppy_dispatch__),
                (http, http_sync.__poppy_dispatch__),
            ]
        self._saved = [(w, w.__poppy_dispatch__) for w, _ in pairs]
        for w, blocking in pairs:
            w.__poppy_dispatch__ = blocking
        return self

    def __exit__(self, *exc):
        for w, orig in self._saved:
            w.__poppy_dispatch__ = orig
        return False


# ---------------------------------------------------------------------------
# redundant-rollout racing


async def _drive_rollout(r):
    """Run one rollout to completion on the racing loop.

    Accepts async callables (awaited directly), annotation wrappers over
    *blocking* components (offloaded to a worker thread so the race stays
    concurrent), and plain sync callables returning either a value or an
    awaitable (e.g. ``lambda: llm(prompt)`` called from external code,
    where the wrapper hands back the coroutine)."""
    if not callable(r):
        raise TypeError(
            f"first_success rollout must be callable, got {type(r).__name__}")
    if registry.is_async_callable(r):
        return await r()
    target = getattr(r, "__poppy_dispatch__", None)
    if target is not None and not registry.is_async_callable(target):
        # a blocking component twin (llm_sync et al.): don't block the loop
        return await asyncio.to_thread(r)
    out = r()
    if inspect.isawaitable(out):
        return await out
    return out


@unordered(returns_immutable=True)
async def first_success(*rollouts, accept=None):
    """Race redundant rollouts; the first acceptable result wins and every
    other rollout is cancelled (speculation's early-termination combinator,
    DESIGN.md §2.4).

    Each rollout is a zero-argument callable — typically a closure over a
    component call, e.g. ``lambda: llm(prompt, temperature=0.8)``.  All
    rollouts launch concurrently; the first to finish with a result that
    ``accept`` admits (default: any non-raising result) wins.  Ties within
    one completion wave break to the lowest argument index, so the race is
    deterministic under simultaneous completion.  Losers are cancelled and
    *drained* before returning — cancellation propagates through the
    dispatcher (admission slots and replica in-flight counts are released
    by its ``finally`` blocks and counted in ``DispatchStats.cancelled``),
    so a race never leaks capacity.

    Raises :class:`~repro_torch.core.errors.FirstSuccessError` with the
    per-rollout outcomes when every rollout fails.  Being ``@unordered``
    with an immutable result, the race itself dispatches the moment its
    closures are ready and composes with branch speculation.
    """
    if not rollouts:
        raise ValueError("first_success needs at least one rollout")
    st = get_dispatcher().stats
    st.races += 1
    tasks = [asyncio.ensure_future(_drive_rollout(r)) for r in rollouts]
    index = {t: i for i, t in enumerate(tasks)}
    failures: list = [None] * len(tasks)
    winner = None
    try:
        with maybe_span("first_success", cat="race", n=len(rollouts)):
            pending = set(tasks)
            while pending and winner is None:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in sorted(done, key=index.__getitem__):
                    i = index[t]
                    if t.cancelled():
                        failures[i] = asyncio.CancelledError()
                        continue
                    e = t.exception()
                    if e is not None:
                        failures[i] = e
                        continue
                    res = t.result()
                    if accept is not None and not accept(res):
                        failures[i] = res
                        continue
                    winner = (i, res)
                    break
            if winner is None:
                raise FirstSuccessError(failures)
            return winner[1]
    finally:
        losers = [t for t in tasks if not t.done()]
        for t in losers:
            t.cancel()
        if losers:
            st.race_losers += len(losers)
            # drain: losers must be fully unwound (dispatcher slots
            # released) before the race returns
            await asyncio.gather(*losers, return_exceptions=True)


# console output must stay in program order; inline offload — a print is
# far cheaper than a thread round-trip, and sequential locks serialize it
# anyway
console_print = sequential(print, offload="inline")
console_print.__name__ = "console_print"


@sequential(offload="inline")
def log(*parts):
    """Ordered log sink (a sequential external, like the paper's print)."""
    print(*parts)
