"""The Dispatcher: production external-call dispatch (DESIGN.md §5); the
port's copy of ``repro/dispatch/dispatcher.py``.

Sits between the PopPy concurrency controllers
(``repro_torch.core.controllers`` → ``repro_torch.core.ai``; a program of
the reference's core may bind a port dispatcher with the reference's
``use_dispatcher`` too) and the backends.  Layering, outermost first::

    cache / coalesce → batch → hedge → route → admit → retry → backend

* **batch** — concurrent requests coalesce into batched backend calls
  (``batcher.MicroBatcher``); the engine's queue-time batch windows also
  land here whole, via ``generate_batch``/``embed_batch``.  Cache lookups
  happen *per element* before batching (a hit never occupies batch
  capacity); a batch then traverses hedge/route/admit/retry as **one**
  request, and per-element failures fail only their element.

* **cache** — identical requests are answered once (LRU + optional disk),
  identical *concurrent* requests coalesce onto one dispatch.
* **hedge** — stragglers race a duplicate; each hedge re-routes, so on a
  multi-replica router the duplicate lands on a different backend.
* **route** — weighted or least-outstanding selection across N replicas.
* **admit** — per-replica token-bucket rate limit + concurrency cap with
  asyncio backpressure (an unbounded ``@unordered`` burst parks instead of
  stampeding).
* **retry** — exponential backoff with deterministic jitter.

A ``Dispatcher()`` with no arguments is the *trivial* dispatcher: it
resolves the ambient ``repro_torch.core.ai`` backend per call and adds no
cache, limits, retries, or hedging — byte-identical behavior to calling
the backend directly, which is what ``repro_torch.core.ai`` installs by
default.

While it calls a backend, a dispatcher binds itself as the ambient
dispatcher of ``repro_torch.core.ai``, so a backend's
``ambient_dispatch_stats()`` (the serving backend's shared-prefix
counters) lands on the dispatcher that routed the call, whichever
package's ``use_dispatcher`` bound it.

Semantics: the dispatcher preserves PopPy's differential-testing invariant.
Under ``sequential_mode()`` calls arrive one at a time and dispatch maps
each to exactly one deterministic backend result; under opportunistic
execution the same per-request function is computed (cache hits are
trace-equivalent to misses — tracing happens above this layer).
"""

from __future__ import annotations

import asyncio
import time

from repro_torch.core.ai import Backend, use_dispatcher
from repro_torch.obs.spans import current_tracer, maybe_span

from .admission import AdmissionController, AdmissionRejected, make_admission
from .batcher import BatchStats, MicroBatcher, make_batch_policy
from .cache import CORRUPT, MISS, make_cache, request_key
from .reliability import (BreakerPolicy, CircuitBreaker, CircuitOpenError,
                          HedgePolicy, RetryPolicy, with_hedge, with_retry)
from .router import Replica, make_router
from .stats import DispatchStats


def _hashable(v) -> bool:
    """Whether ``v`` can key a micro-batch window (a list-valued ``stop``
    sequence, say, cannot — such requests dispatch without windowing)."""
    try:
        hash(v)
    except TypeError:
        return False
    return True


class _AmbientReplica(Replica):
    """Late-bound replica for the trivial dispatcher: resolves the current
    ``repro_torch.core.ai`` backend (the ``use_backend`` contextvar) per
    call."""

    def resolve(self):
        from repro_torch.core.ai import get_backend
        return get_backend()


class Dispatcher(Backend):
    """Multi-backend dispatch implementing the ``Backend`` interface, so it
    drops in anywhere a backend is used (including inside another
    dispatcher's replica list, for hierarchical routing)."""

    def __init__(self, backends=None, *, policy="least_outstanding",
                 weights=None, names=None, cache=None, admission=None,
                 retry: RetryPolicy | None = None,
                 hedge: HedgePolicy | None = None,
                 batch=None,
                 breaker: BreakerPolicy | None = None,
                 faults=None,
                 stats: DispatchStats | None = None):
        self.stats = stats if stats is not None else DispatchStats()
        self.batch_policy = make_batch_policy(batch)
        self.batch_stats = BatchStats(
            self.batch_policy.max_batch if self.batch_policy else None,
            registry=self.stats.registry)
        self.stats.batch = self.batch_stats
        self.batcher = MicroBatcher(self.batch_policy, self._execute_batch,
                                    self.batch_stats) \
            if self.batch_policy is not None else None
        if backends is not None:
            self.router = make_router(backends, policy=policy,
                                      weights=weights, names=names)
        else:
            self.router = None
            self._ambient = _AmbientReplica(backend=None, name="ambient")
        self.cache = make_cache(cache)
        # one admission gate per replica (per-backend limits); the trivial
        # dispatcher gets a single gate guarding the ambient backend.  A
        # pre-built controller contributes its *policy* — sharing one gate
        # instance across replicas would silently merge per-backend limits
        # into a global one.
        if isinstance(admission, AdmissionController):
            admission = admission.policy
        self._admission_policy = admission
        replicas = self.router.replicas if self.router else [self._ambient]
        self._gate = {id(r): make_admission(admission) for r in replicas}
        self.retry = retry
        self.hedge = hedge
        # per-backend circuit breakers (DESIGN.md §2.5): one breaker per
        # replica, transitions fanned into counters + span events
        self._breaker = {
            id(r): CircuitBreaker(breaker, name=r.name,
                                  on_transition=self._on_breaker)
            for r in replicas} if breaker is not None else None
        # fault injection (repro_torch.durability.faults): applied per backend
        # attempt, inside the retry loop, so retries see fresh draws
        from repro_torch.durability.faults import make_injector
        self.faults = make_injector(faults)
        if self.faults is not None and self.faults.on_fault is None:
            self.faults.on_fault = self._on_fault

    # -- chaos / breaker event fan-in ---------------------------------------

    def _on_fault(self, backend: str, kind: str):
        self.stats.faults_injected += 1
        trz = current_tracer()
        if trz is not None:
            trz.event(f"fault.{kind}", cat="dispatch.fault",
                      backend=backend)

    def _on_breaker(self, backend: str, state: str):
        st = self.stats
        if state == CircuitBreaker.OPEN:
            st.breaker_opens += 1
        elif state == CircuitBreaker.CLOSED:
            st.breaker_closes += 1
        else:
            st.breaker_probes += 1
        trz = current_tracer()
        if trz is not None:
            trz.event(f"breaker.{state}", cat="dispatch.breaker",
                      backend=backend)

    # -- Backend interface ---------------------------------------------------

    async def generate(self, prompt, *, max_tokens, temperature, stop,
                       domains=()):
        # sampled completions (temperature > 0) are independent draws, not a
        # pure function of the request — never serve them from cache
        return await self.dispatch(
            "generate", (prompt, max_tokens, temperature, stop),
            lambda b: b.generate(prompt, max_tokens=max_tokens,
                                 temperature=temperature, stop=stop),
            cacheable=temperature <= 0.0, domains=domains,
            batch=(("generate", (max_tokens, temperature, stop)), prompt),
            hint=prompt)

    async def embed(self, text, domains=()):
        return await self.dispatch("embed", (text,),
                                   lambda b: b.embed(text), domains=domains,
                                   batch=(("embed", ()), text), hint=text)

    async def generate_batch(self, prompts, *, max_tokens, temperature,
                             stop, domains=()):
        """Batched twin of :meth:`generate` (this is where an engine batch
        window lands).  Per-element cache lookups and in-flight coalescing
        happen first; the remaining misses traverse hedge → route → admit →
        retry as **one** batched backend request.  Returns one result per
        prompt in order; a failed element is returned as its ``Exception``
        instance (per-element error isolation)."""
        return await self._batch_pipeline(
            "generate", (max_tokens, temperature, stop), list(prompts),
            cacheable=temperature <= 0.0, domains=domains)

    async def embed_batch(self, texts, domains=()):
        """Batched twin of :meth:`embed` (see :meth:`generate_batch`)."""
        return await self._batch_pipeline("embed", (), list(texts),
                                          domains=domains)

    # -- dispatch pipeline ---------------------------------------------------

    async def dispatch(self, kind: str, payload, call, *, cacheable=True,
                       domains=(), batch=None, hint=None):
        """Dispatch ``call(backend) -> awaitable`` for a request identified
        by ``(kind, payload)`` through cache → batch → hedge → route →
        admit → retry.  ``domains`` tags the request with its effect-domain
        keys for the per-domain stats view (purely observational).
        ``batch`` is ``(group, element)`` — when a micro-batcher is
        configured, the request windows with identical-``group`` traffic
        instead of dispatching alone.  ``hint`` is the request's prompt
        text (or other affinity token), passed to the router's ``pick`` so
        a prefix-affinity policy can place it."""
        self.stats.requests += 1
        if domains:
            self.stats.note_domains(domains)
        use_cache = self.cache is not None and cacheable
        needs_key = use_cache or self.retry is not None
        key = request_key(kind, payload) if needs_key else ""
        with maybe_span(f"dispatch:{kind}", cat="dispatch", kind=kind,
                        cached=use_cache):
            if self.batcher is not None and batch is not None \
                    and _hashable(batch[0]):
                group, element = batch

                def runner():
                    return self._one_via_batcher(group, element)
            else:
                def runner():
                    return self._hedged(key, call, hint=hint)
            if not use_cache:
                return await runner()
            return await self.cache.get_or_dispatch(key, runner,
                                                    self.stats)

    async def _one_via_batcher(self, group, element):
        (r,) = await self.batcher.submit_many(group, [element])
        if isinstance(r, BaseException):
            raise r
        return r

    # -- batched pipeline ----------------------------------------------------

    @staticmethod
    def _element_payload(kind: str, payload, opts):
        """The single-call request payload for one batch element — element
        cache keys must equal the keys ``generate``/``embed`` would use, so
        the tiers interoperate across batched and unbatched traffic."""
        return (payload, *opts) if kind == "generate" else (payload,)

    async def _batch_pipeline(self, kind: str, opts, payloads, *,
                              cacheable=True, domains=()):
        st = self.stats
        n = len(payloads)
        st.requests += n
        if domains:
            for _ in range(n):
                st.note_domains(domains)
        group = (kind, opts)
        # an unhashable group (e.g. a list-valued stop sequence) cannot key
        # a micro-batch window; the burst still dispatches as one batch
        use_batcher = self.batcher is not None and _hashable(group)
        use_cache = self.cache is not None and cacheable
        with maybe_span(f"dispatch.batch:{kind}", cat="dispatch.batch",
                        kind=kind, n=n):
            return await self._batch_pipeline_inner(
                kind, opts, payloads, group, use_batcher, use_cache, n, st)

    async def _batch_pipeline_inner(self, kind, opts, payloads, group,
                                    use_batcher, use_cache, n, st):
        if not use_cache:
            if use_batcher:
                return await self.batcher.submit_many(group, payloads)
            return await self._execute_batch(group, payloads)
        cache = self.cache
        keys = [request_key(kind, self._element_payload(kind, p, opts))
                for p in payloads]
        results: list = [None] * n
        # per-element cache tiers: memory, then disk (disk probes gathered —
        # n sequential thread hops would stall the whole batch)
        misses = []
        for i in range(n):
            v = cache.mem.get(keys[i])
            if v is not MISS:
                st.cache_hits += 1
                results[i] = v
            else:
                misses.append(i)
        if cache.disk is not None and misses:
            probed = await asyncio.gather(
                *(asyncio.to_thread(cache.disk.get, keys[i])
                  for i in misses))
            still = []
            for i, v in zip(misses, probed):
                if v is CORRUPT:
                    st.disk_corrupt += 1
                    v = MISS
                if v is not MISS:
                    cache.mem.put(keys[i], v)
                    st.cache_hits += 1
                    st.disk_hits += 1
                    results[i] = v
                else:
                    still.append(i)
            misses = still
        # in-flight coalescing: join an identical outstanding element
        # (possibly an earlier element of this very batch)
        waiters, primaries = [], []
        for i in misses:
            fut, primary = cache.claim(keys[i])
            if primary:
                st.cache_misses += 1
                primaries.append((i, fut))
            else:
                st.coalesced += 1
                waiters.append((i, fut))
        if primaries:
            batch_payloads = [payloads[i] for i, _ in primaries]
            try:
                if use_batcher:
                    rs = await self.batcher.submit_many(group, batch_payloads)
                else:
                    rs = await self._execute_batch(group, batch_payloads)
            except BaseException as e:
                for i, fut in primaries:
                    cache.settle(keys[i], fut, exc=e)
                raise
            for (i, fut), r in zip(primaries, rs):
                results[i] = r
                if isinstance(r, BaseException):
                    cache.settle(keys[i], fut, exc=r)
                else:
                    cache.settle(keys[i], fut, result=r)
            if cache.disk is not None:
                # after delivery: a slow disk must not delay waiters
                await asyncio.gather(
                    *(asyncio.to_thread(cache.disk.put, keys[i], r)
                      for (i, _), r in zip(primaries, rs)
                      if not isinstance(r, BaseException)))
        for i, fut in waiters:
            try:
                async def _redispatch(i=i):
                    (r,) = await self._execute_batch(group, [payloads[i]])
                    return r

                results[i] = await cache.join(fut, _redispatch)
            except BaseException as e:
                if isinstance(e, asyncio.CancelledError):
                    raise
                results[i] = e
        return results

    async def _execute_batch(self, group, payloads) -> list:
        """One batched backend request: hedge → route → admit → retry, a
        single admission unit regardless of batch size."""
        n = len(payloads)
        key = request_key(f"{group[0]}.batch", (tuple(payloads), group[1]))
        # a batch routes as one unit: its first element's prompt is the
        # affinity hint (engine batch windows share a prefix, so any
        # element identifies the warm replica)
        hint = payloads[0] if payloads and isinstance(payloads[0], str) \
            else None
        results = await self._hedged(
            key, lambda b: self._backend_batch(b, group, payloads),
            hint=hint)
        if not isinstance(results, (list, tuple)) or len(results) != n:
            raise RuntimeError(
                f"batched backend returned {type(results).__name__} of "
                f"length "
                f"{len(results) if isinstance(results, (list, tuple)) else 'n/a'}"
                f", expected {n} results")
        self.batch_stats.record_batch(n)
        return list(results)

    async def _backend_batch(self, backend, group, payloads) -> list:
        kind, opts = group
        if kind == "generate":
            mt, tp, stp = opts
            meth = getattr(backend, "generate_batch", None)
            if meth is not None:
                return await meth(list(payloads), max_tokens=mt,
                                  temperature=tp, stop=stp)
            coros = [backend.generate(p, max_tokens=mt, temperature=tp,
                                      stop=stp) for p in payloads]
        else:
            meth = getattr(backend, "embed_batch", None)
            if meth is not None:
                return await meth(list(payloads))
            coros = [backend.embed(p) for p in payloads]
        # list-payload-unaware backend: per-element fallback (still one
        # admission; failures isolate per element via return_exceptions)
        return list(await asyncio.gather(*coros, return_exceptions=True))

    async def _hedged(self, key, call, hint=None):
        if self.hedge is None:
            return await self._routed(key, call, hint=hint)
        st = self.stats

        def on_hedge():
            st.hedges += 1
            trz = current_tracer()
            if trz is not None:
                trz.event("hedge", cat="dispatch")

        def on_win():
            st.hedge_wins += 1
            trz = current_tracer()
            if trz is not None:
                trz.event("hedge.win", cat="dispatch")

        return await with_hedge(
            lambda: self._routed(key, call, hint=hint), self.hedge,
            on_hedge=on_hedge, on_win=on_win)

    def _pick(self, hint=None) -> tuple[Replica, object]:
        replica = self.router.pick(hint) if self.router is not None \
            else self._ambient
        return replica, self._gate[id(replica)]

    def _note_route(self, replica: Replica, hint):
        """Per-replica routing counters: re-probe the *picked* replica's
        prefix digest for the hit-depth metric.  The probe is a read-only
        radix-trie walk, and probing here (rather than trusting the
        router) gives the same counters under every policy — the affinity
        benchmark compares policies from identical instrumentation."""
        matched = None
        if hint is not None:
            probe = getattr(replica.resolve(), "prefix_probe", None)
            if probe is not None:
                try:
                    matched = int(probe(hint))
                except Exception:
                    matched = None
        self.stats.note_route(replica.name, matched)

    async def _routed(self, key, call, hint=None):
        replica, gate = self._pick(hint)
        self._note_route(replica, hint)
        st = self.stats
        # breaker fast-fail *before* admission: a request to a dead
        # backend must not occupy queue capacity waiting to fail
        br = self._breaker.get(id(replica)) \
            if self._breaker is not None else None
        if br is not None and not br.allow():
            st.breaker_fastfails += 1
            trz = current_tracer()
            if trz is not None:
                trz.event("breaker.fastfail", cat="dispatch.breaker",
                          backend=replica.name)
            raise CircuitOpenError(replica.name)
        if gate is None:
            return await self._attempt(replica, key, call)
        # the admission wait is begin/end-bracketed (not a ``with``) so the
        # span closes when the gate admits, not when the attempt finishes;
        # ``end`` is idempotent, so the finally covers the reject path
        trz = current_tracer()
        adm = trz.begin("admission.wait", cat="dispatch.admit",
                        backend=replica.name) if trz is not None else None
        st.enqueue()
        admitted = False
        try:
            async with gate:
                if adm is not None:
                    trz.end(adm)
                st.dequeue()
                admitted = True
                return await self._attempt(replica, key, call)
        except AdmissionRejected:
            st.rejected += 1
            if adm is not None:
                adm.attrs["rejected"] = True
            raise
        finally:
            if adm is not None:
                trz.end(adm)
            if not admitted:
                st.dequeue()

    async def _attempt(self, replica: Replica, key, call):
        st = self.stats
        backend = replica.resolve()
        replica.begin()
        bs = st.backend(replica.name)
        bs.outstanding_peak = max(bs.outstanding_peak, replica.outstanding)
        st.dispatched += 1
        br = self._breaker.get(id(replica)) \
            if self._breaker is not None else None
        fi = self.faults

        def on_retry(a):
            st.retries += 1
            trz = current_tracer()
            if trz is not None:
                trz.event("retry", cat="dispatch", attempt=a,
                          backend=replica.name)

        async def once():
            # every try perturbs (injected chaos) and reports its own
            # outcome to the breaker — retries that a policy absorbs must
            # still count toward the consecutive-failure threshold
            try:
                if fi is not None:
                    await fi.perturb(replica.name)
                with use_dispatcher(self):
                    r = await call(backend)
            except asyncio.CancelledError:
                raise  # abandoned, not failed: breaker state unchanged
            except BaseException:
                if br is not None:
                    br.record_failure()
                raise
            if br is not None:
                br.record_success()
            return r

        t0 = time.monotonic()
        try:
            with maybe_span("attempt", cat="backend",
                            track=f"backend:{replica.name}",
                            backend=replica.name,
                            outstanding=replica.outstanding):
                result = await with_retry(
                    once, self.retry, key=key,
                    on_retry=on_retry)
        except BaseException as e:
            if isinstance(e, asyncio.CancelledError):
                # speculation rollback / first_success loser: the attempt
                # was abandoned, not failed — count it separately so error
                # rates stay meaningful
                st.cancelled += 1
            st.observe(replica.name, time.monotonic() - t0, error=True)
            raise
        finally:
            replica.end()
        st.observe(replica.name, time.monotonic() - t0)
        return result
