"""The port's dispatch layer (``repro_torch.dispatch``) against the
reference's (``repro.dispatch``): the cases of ``test_dispatch.py`` and
``test_dispatch_batcher.py``, each run on both packages, and the
cross-package checks — request keys, retry backoffs and the disk cache's
files are the same bytes in both.

The backends are the reference's ``SimulatedBackend`` (the port has no
simulated model); the PopPy programs run on the reference's runtime with
either package's dispatcher bound through ``repro.core.ai.use_dispatcher``.
"""

import asyncio
import time
import types

import pytest

import repro.core.ai as ai_ref
import repro.dispatch as dispatch_ref
import repro.dispatch.cache as cache_ref
import repro.dispatch.reliability as reliability_ref
import repro_torch.core.ai as ai_port
import repro_torch.dispatch as dispatch_port
import repro_torch.dispatch.cache as cache_port
import repro_torch.dispatch.reliability as reliability_port
from repro.core import equivalent, poppy, recording, sequential_mode
from repro.core.ai import Backend, SimulatedBackend, embed, llm

PACKAGES = {
    "reference": types.SimpleNamespace(d=dispatch_ref, ai=ai_ref,
                                       rel=reliability_ref),
    "port": types.SimpleNamespace(d=dispatch_port, ai=ai_port,
                                  rel=reliability_port),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def run(coro):
    return asyncio.run(coro)


def fast_backend(**kw):
    return SimulatedBackend(time_scale=0.02, **kw)


async def gen(d, prompt, **kw):
    kw.setdefault("max_tokens", 8)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("stop", None)
    return await d.generate(prompt, **kw)


class FlakyBackend(Backend):
    """Fails the first ``fail_first`` generate calls, then succeeds."""

    def __init__(self, fail_first, inner=None):
        self.fail_first = fail_first
        self.inner = inner or fast_backend()
        self.attempts = 0

    async def generate(self, prompt, *, max_tokens, temperature, stop):
        self.attempts += 1
        if self.attempts <= self.fail_first:
            await asyncio.sleep(0.005)    # fail like a network call: late
            raise ConnectionError(f"injected failure #{self.attempts}")
        return await self.inner.generate(
            prompt, max_tokens=max_tokens, temperature=temperature,
            stop=stop)

    async def embed(self, text):
        return await self.inner.embed(text)


class StragglerBackend(Backend):
    """Deterministic straggler: every call stalls ``stall_s``."""

    def __init__(self, stall_s, inner=None):
        self.stall_s = stall_s
        self.inner = inner or fast_backend()
        self.calls = 0

    async def generate(self, prompt, *, max_tokens, temperature, stop):
        self.calls += 1
        await asyncio.sleep(self.stall_s)
        return await self.inner.generate(
            prompt, max_tokens=max_tokens, temperature=temperature,
            stop=stop)

    async def embed(self, text):
        await asyncio.sleep(self.stall_s)
        return await self.inner.embed(text)


# -- routing ----------------------------------------------------------------


def test_weighted_router_distribution(pkg):
    r = pkg.d.make_router(["a", "b"], policy="weighted", weights=[3, 1])
    picks = [r.pick().backend for _ in range(40)]
    assert picks.count("a") == 30 and picks.count("b") == 10
    assert picks[:4].count("a") == 3


def test_least_outstanding_prefers_idle(pkg):
    r = pkg.d.make_router(["a", "b"], policy="least_outstanding")
    ra = r.pick()
    ra.begin()
    assert r.pick().backend != ra.backend
    ra.end()


def test_unknown_policy_rejected(pkg):
    with pytest.raises(ValueError, match="unknown routing policy"):
        pkg.d.make_router(["a"], policy="round_trip")


def test_dispatcher_balances_replicas(pkg):
    b1, b2 = fast_backend(), fast_backend()
    d = pkg.d.Dispatcher([b1, b2])

    async def go():
        await asyncio.gather(*[gen(d, f"p{i}") for i in range(8)])

    run(go())
    assert len(b1.calls) == len(b2.calls) == 4


# -- admission control ------------------------------------------------------


def test_concurrency_cap_backpressure(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], admission=pkg.d.AdmissionPolicy(
        max_concurrency=2))

    async def go():
        return await asyncio.gather(*[gen(d, f"p{i}") for i in range(10)])

    outs = run(go())
    assert be.max_in_flight <= 2
    assert len(be.calls) == 10
    direct = [run(gen(fast_backend(), f"p{i}")) for i in range(10)]
    assert outs == direct


def test_token_bucket_paces_requests(pkg):
    async def go():
        tb = pkg.d.TokenBucket(rate=200.0, burst=1)
        t0 = time.monotonic()
        for _ in range(5):
            await tb.acquire()
        return time.monotonic() - t0

    assert run(go()) >= 4 * (1 / 200.0) * 0.8


def test_admission_queue_overflow_sheds_load(pkg):
    be = StragglerBackend(0.2)
    d = pkg.d.Dispatcher([be], admission=pkg.d.AdmissionPolicy(
        max_concurrency=1, max_queue=2))

    async def go():
        return await asyncio.gather(
            *[gen(d, f"p{i}") for i in range(6)], return_exceptions=True)

    outs = run(go())
    rejected = [o for o in outs if isinstance(o, pkg.d.AdmissionRejected)]
    assert rejected and d.stats.rejected == len(rejected)
    assert any(isinstance(o, str) for o in outs)


# -- cache + coalescing -----------------------------------------------------


def test_cache_hit_is_deterministic(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        return await gen(d, "same prompt"), await gen(d, "same prompt")

    a, b = run(go())
    assert a == b
    assert len(be.calls) == 1
    assert d.stats.cache_hits == 1 and d.stats.cache_misses == 1


def test_cache_key_separates_params(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        await gen(d, "p", max_tokens=4)
        await gen(d, "p", max_tokens=6)

    run(go())
    assert len(be.calls) == 2


def test_inflight_coalescing(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        return await asyncio.gather(*[gen(d, "dup") for _ in range(8)])

    outs = run(go())
    assert len(set(outs)) == 1
    assert len(be.calls) == 1
    assert d.stats.coalesced == 7


def test_coalesced_failure_propagates(pkg):
    be = FlakyBackend(fail_first=100)
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        return await asyncio.gather(
            *[gen(d, "dup") for _ in range(4)], return_exceptions=True)

    outs = run(go())
    assert all(isinstance(o, ConnectionError) for o in outs)
    assert be.attempts == 1
    with pytest.raises(ConnectionError):
        run(gen(d, "dup"))
    assert be.attempts == 2


def test_disk_cache_survives_dispatcher_restart(pkg, tmp_path):
    be1 = fast_backend()
    d1 = pkg.d.Dispatcher([be1], cache=dict(disk_dir=tmp_path))

    async def first():
        return await gen(d1, "persist me"), await d1.embed("vec")

    g1, e1 = run(first())
    assert isinstance(e1, tuple)
    be2 = fast_backend()
    d2 = pkg.d.Dispatcher([be2], cache=dict(disk_dir=tmp_path))

    async def second():
        return await gen(d2, "persist me"), await d2.embed("vec")

    g2, e2 = run(second())
    assert (g1, e1) == (g2, e2)
    assert isinstance(e2, tuple)
    assert len(be2.calls) == 0
    assert d2.stats.disk_hits == 2


def test_sampled_completions_bypass_cache(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        await gen(d, "sample me", temperature=0.8)
        await gen(d, "sample me", temperature=0.8)
        await gen(d, "sample me")
        await gen(d, "sample me")
        return len(be.calls)

    assert run(go()) == 3
    assert d.stats.cache_hits == 1


def test_coalesced_waiter_survives_primary_cancellation(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        primary = asyncio.ensure_future(gen(d, "shared"))
        await asyncio.sleep(0.001)
        waiter = asyncio.ensure_future(gen(d, "shared"))
        await asyncio.sleep(0.001)
        primary.cancel()
        return await waiter

    assert run(go()) == run(gen(fast_backend(), "shared"))


def test_admission_controller_instance_stays_per_replica(pkg):
    b1, b2 = fast_backend(), fast_backend()
    ctl = pkg.d.AdmissionController(pkg.d.AdmissionPolicy(max_concurrency=2))
    d = pkg.d.Dispatcher([b1, b2], admission=ctl)

    async def go():
        await asyncio.gather(*[gen(d, f"p{i}") for i in range(12)])

    run(go())
    assert b1.max_in_flight <= 2 and b2.max_in_flight <= 2
    assert b1.max_in_flight + b2.max_in_flight == 4


def test_lru_eviction(pkg):
    be = fast_backend()
    d = pkg.d.Dispatcher([be], cache=pkg.d.ResultCache(capacity=2))

    async def go():
        for p in ("a", "b", "c", "a"):
            await gen(d, p)
        return len(be.calls)

    assert run(go()) == 4


# -- reliability ------------------------------------------------------------


def test_retry_recovers_from_transient_failures(pkg):
    be = FlakyBackend(fail_first=2)
    d = pkg.d.Dispatcher([be], retry=pkg.d.RetryPolicy(max_attempts=4,
                                                       base_s=0.001))
    assert isinstance(run(gen(d, "flaky")), str)
    assert be.attempts == 3
    assert d.stats.retries == 2


def test_retry_exhaustion_raises(pkg):
    be = FlakyBackend(fail_first=10)
    d = pkg.d.Dispatcher([be], retry=pkg.d.RetryPolicy(max_attempts=3,
                                                       base_s=0.001))
    with pytest.raises(ConnectionError):
        run(gen(d, "flaky"))
    assert be.attempts == 3


def test_backoff_jitter_is_deterministic(pkg):
    p = pkg.d.RetryPolicy(base_s=0.1, jitter_frac=0.3)
    backoff_s = pkg.rel.backoff_s
    assert backoff_s(p, 1, "k") == backoff_s(p, 1, "k")
    assert backoff_s(p, 1, "k") != backoff_s(p, 2, "k")
    assert backoff_s(p, 2, "k") <= p.max_backoff_s * (1 + p.jitter_frac)


def test_hedge_beats_straggler(pkg):
    slow = StragglerBackend(0.5)
    fast = fast_backend()
    d = pkg.d.Dispatcher([slow, fast], policy="least_outstanding",
                         hedge=pkg.d.HedgePolicy(delay_s=0.05))

    async def go():
        t0 = time.monotonic()
        out = await gen(d, "straggler")
        return out, time.monotonic() - t0

    out, dt = run(go())
    assert d.stats.hedges >= 1 and d.stats.hedge_wins >= 1
    assert dt < 0.5
    assert out == run(gen(fast_backend(), "straggler"))


def test_hedge_result_matches_unhedged(pkg):
    b1, b2 = fast_backend(), fast_backend()
    d = pkg.d.Dispatcher([b1, b2], hedge=pkg.d.HedgePolicy(delay_s=0.001,
                                                           max_hedges=1))

    async def go():
        return await asyncio.gather(*[gen(d, f"h{i}") for i in range(6)])

    direct = [run(gen(fast_backend(), f"h{i}")) for i in range(6)]
    assert run(go()) == direct


# -- differential: dispatch preserves PopPy semantics -----------------------


@poppy
def fanout_app(n):
    summaries = tuple()
    for i in range(n):
        s = llm(f"summarize shard {i % 3}", max_tokens=8)
        summaries += (s,)
    e = embed("query")
    combined = llm(f"combine: {summaries} {e[0]:.3f}", max_tokens=12)
    return combined


def test_default_dispatch_is_transparent(pkg):
    """The trivial dispatcher over the ambient backend gives what
    ``sequential_mode()`` over a direct backend gives, call for call and
    trace for trace."""
    be1 = fast_backend()
    with ai_ref.use_dispatcher(pkg.d.Dispatcher()), \
            pkg.ai.use_backend(be1), recording() as tr1:
        r1 = fanout_app(6)
    be2 = fast_backend()
    with ai_ref.use_backend(be2), sequential_mode(), recording() as tr2:
        r2 = fanout_app(6)
    assert r1 == r2
    assert be1.calls and len(be1.calls) == len(be2.calls)
    ok, why = equivalent(tr1, tr2)
    assert ok, why


def test_dispatch_preserves_sequential_semantics(pkg):
    direct = fast_backend()
    with ai_ref.use_backend(direct), sequential_mode():
        expect = fanout_app(6)
    d = pkg.d.Dispatcher([fast_backend(), fast_backend()], cache=True,
                         admission=pkg.d.AdmissionPolicy(
                             max_concurrency=4, rate=2000.0, burst=8),
                         retry=pkg.d.RetryPolicy(max_attempts=2,
                                                 base_s=0.001),
                         hedge=pkg.d.HedgePolicy(delay_s=0.5))
    with ai_ref.use_dispatcher(d), recording() as tr_cold:
        r_cold = fanout_app(6)
    with ai_ref.use_dispatcher(d), recording() as tr_warm:
        r_warm = fanout_app(6)
    assert r_cold == expect and r_warm == expect
    ok, why = equivalent(tr_cold, tr_warm)
    assert ok, f"cache hits not trace-equivalent to misses: {why}"
    assert d.stats.hit_rate > 0
    with ai_ref.use_dispatcher(d), sequential_mode():
        assert fanout_app(6) == expect


def test_dispatcher_nests_as_backend(pkg):
    inner = pkg.d.Dispatcher([fast_backend()], cache=True)
    outer = pkg.d.Dispatcher([inner])
    assert run(gen(outer, "nested")) == run(gen(fast_backend(), "nested"))


# -- the micro-batcher ------------------------------------------------------


def test_make_batch_policy_forms(pkg):
    mk = pkg.d.make_batch_policy
    assert mk(None) is None
    assert mk(True).max_batch == 32
    p = mk({"max_batch": 4, "max_wait_s": 0.1})
    assert (p.max_batch, p.max_wait_s) == (4, 0.1)
    q = pkg.d.BatchPolicy(max_batch=2)
    assert mk(q) is q


def test_concurrent_singles_window_into_one_batch(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], batch=pkg.d.BatchPolicy(max_batch=8,
                                                       max_wait_s=0.05))

    async def go():
        return await asyncio.gather(*(
            d.generate(f"p{i}", max_tokens=4, temperature=0.0, stop=None)
            for i in range(5)))

    assert run(go()) == [be.response(f"p{i}", 4) for i in range(5)]
    assert be.batches == [5], be.batches
    snap = d.batch_stats.snapshot()
    assert snap["batches"] == 1 and snap["elements"] == 5
    assert snap["size_hist"] == {5: 1}
    assert 0 < snap["fill_ratio"] == 5 / 8
    assert "batches: 1 carrying 5 elements" in d.stats.report()


def test_full_window_flushes_without_timer(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], batch=pkg.d.BatchPolicy(max_batch=3,
                                                       max_wait_s=10.0))

    async def go():
        return await asyncio.gather(*(d.embed(f"t{i}") for i in range(6)))

    assert len(run(asyncio.wait_for(go(), timeout=5.0))) == 6
    assert be.batches == [3, 3], be.batches


def test_generate_batch_one_admission_unit(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], admission=pkg.d.AdmissionPolicy(
        max_concurrency=1))

    async def go():
        return await d.generate_batch(
            [f"p{i}" for i in range(8)], max_tokens=4, temperature=0.0,
            stop=None)

    assert run(go()) == [be.response(f"p{i}", 4) for i in range(8)]
    assert be.batches == [8]
    assert d.stats.dispatched == 1
    assert be.max_in_flight == 8


def test_batch_pipeline_cache_hits_and_coalescing(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        first = await d.embed_batch(["a", "b"])
        second = await d.embed_batch(["a", "c", "c", "d"])
        return first, second

    first, second = run(go())
    assert second[0] == first[0]
    assert second[1] == second[2]
    assert be.batches == [2, 2]
    assert d.stats.cache_hits == 1
    assert d.stats.coalesced == 1
    assert d.stats.cache_misses == 4


def test_per_element_error_isolation_and_no_error_caching(pkg):
    class PartlyFailing(SimulatedBackend):
        async def generate_batch(self, prompts, *, max_tokens, temperature,
                                 stop):
            return [RuntimeError(f"boom {p}") if p.startswith("bad")
                    else self.response(p, max_tokens) for p in prompts]

    be = PartlyFailing(time_scale=0.01)
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        r1 = await d.generate_batch(["ok1", "bad1", "ok2"], max_tokens=4,
                                    temperature=0.0, stop=None)
        r2 = await d.generate_batch(["bad1", "ok1"], max_tokens=4,
                                    temperature=0.0, stop=None)
        return r1, r2

    r1, r2 = run(go())
    assert r1[0] == be.response("ok1", 4)
    assert isinstance(r1[1], RuntimeError)
    assert r1[2] == be.response("ok2", 4)
    assert isinstance(r2[0], RuntimeError)
    assert r2[1] == be.response("ok1", 4)
    assert d.stats.cache_hits == 1
    assert not d.cache.inflight


def test_duck_typed_backend_gather_fallback(pkg):
    class Bare:   # deliberately not a Backend subclass
        def __init__(self):
            self.calls = []

        async def generate(self, prompt, *, max_tokens, temperature, stop):
            self.calls.append(prompt)
            if prompt == "bad":
                raise ValueError("nope")
            return f"g:{prompt}"

        async def embed(self, text):
            self.calls.append(text)
            return (1.0,)

    be = Bare()
    d = pkg.d.Dispatcher([be])

    async def go():
        return await d.generate_batch(["x", "bad", "y"], max_tokens=4,
                                      temperature=0.0, stop=None)

    outs = run(go())
    assert outs[0] == "g:x" and outs[2] == "g:y"
    assert isinstance(outs[1], ValueError)
    assert sorted(be.calls) == ["bad", "x", "y"]
    assert d.stats.dispatched == 1


def test_singles_and_batches_share_cache_keys(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], cache=True)

    async def go():
        await d.generate_batch(["p"], max_tokens=4, temperature=0.0,
                               stop=None)
        return await d.generate("p", max_tokens=4, temperature=0.0,
                                stop=None)

    assert run(go()) == be.response("p", 4)
    assert d.stats.cache_hits == 1
    assert len(be.calls) == 1


def test_ambient_trivial_dispatcher_batches(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher()

    async def go():
        with pkg.ai.use_backend(be):
            return await d.embed_batch(["u", "v"])

    assert run(go()) == [be._embedding("u"), be._embedding("v")]
    assert be.batches == [2]


def test_list_valued_stop_bypasses_windowing(pkg):
    be = SimulatedBackend(time_scale=0.01)
    d = pkg.d.Dispatcher([be], batch=pkg.d.BatchPolicy(max_batch=8,
                                                       max_wait_s=0.01))

    async def go():
        single = await d.generate("p", max_tokens=4, temperature=0.0,
                                  stop=["END"])
        burst = await d.generate_batch(["q", "r"], max_tokens=4,
                                       temperature=0.0, stop=["END"])
        return single, burst

    single, burst = run(go())
    assert single == be.response("p", 4)
    assert burst == [be.response("q", 4), be.response("r", 4)]
    assert be.batches == [2], be.batches


# -- the port alone ---------------------------------------------------------


def test_port_get_backend_without_binding_raises():
    """The reference falls back to its simulated model; the port has none."""
    with pytest.raises(RuntimeError, match="no backend bound"):
        run(gen(dispatch_port.Dispatcher(), "p"))
    be = fast_backend()

    async def bound():
        with ai_port.use_backend(be):
            return await gen(dispatch_port.Dispatcher(), "p")

    assert run(bound()) == run(gen(fast_backend(), "p"))
    assert be.calls


def test_port_dispatcher_binds_itself_around_a_backend_call():
    """A backend called by a port dispatcher sees that dispatcher as the
    ambient one, even when nothing bound it in the port's contextvar."""
    seen = []

    class Probe(Backend):
        async def generate(self, prompt, *, max_tokens, temperature, stop):
            seen.append(ai_port.get_dispatcher())
            return prompt

    d = dispatch_port.Dispatcher([Probe()])
    assert run(gen(d, "x")) == "x"
    assert seen == [d]
    assert ai_port.get_dispatcher() is not d


# -- the two packages give the same bytes -----------------------------------

PAYLOADS = [
    ("generate", ("hello", 8, 0.0, None)),
    ("generate", ("ünïcode ✓", 16, 0.7, ("END", "\n"))),
    ("embed", ("query",)),
    ("generate.batch", (("a", "b", "c"), (4, 0.0, None))),
    ("embed", (1, 2.5, True, None, -0.0, 1e-300)),
]


@pytest.mark.parametrize("kind,payload", PAYLOADS,
                         ids=[str(i) for i in range(len(PAYLOADS))])
def test_request_key_equal_across_packages(kind, payload):
    assert cache_port.request_key(kind, payload) == \
        cache_ref.request_key(kind, payload)


def test_encode_decode_equal_across_packages():
    values = ["text", (0.25, -1.5, 3.0), [("a", 1), ["b", (2,)]], None,
              {"k": (1, 2)}]
    for v in values:
        assert cache_port._encode(v) == cache_ref._encode(v)
        assert cache_port._decode(cache_ref._encode(v)) == \
            cache_ref._decode(cache_ref._encode(v))


def test_backoff_equal_across_packages():
    for jitter in (0.0, 0.1, 0.3):
        p_ref = reliability_ref.RetryPolicy(base_s=0.05, jitter_frac=jitter)
        p_port = reliability_port.RetryPolicy(base_s=0.05,
                                              jitter_frac=jitter)
        for key in ("", "k", "a" * 64):
            for attempt in range(1, 9):
                assert reliability_port.backoff_s(p_port, attempt, key) == \
                    reliability_ref.backoff_s(p_ref, attempt, key)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_disk_cache_read_back_across_packages(tmp_path, writer, reader):
    """A disk tier written through one package's dispatcher answers the
    other's with no backend call, and the files are the same bytes."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    be1 = fast_backend()
    d1 = w.d.Dispatcher([be1], cache=dict(disk_dir=tmp_path / "a"))

    async def calls(d):
        return (await gen(d, "persist me"), await d.embed("vec"),
                await d.generate_batch(["x", "y"], max_tokens=8,
                                       temperature=0.0, stop=None))

    first = run(calls(d1))
    be2 = fast_backend()
    d2 = r.d.Dispatcher([be2], cache=dict(disk_dir=tmp_path / "a"))
    assert run(calls(d2)) == first
    assert len(be2.calls) == 0 and be2.batches == []
    assert d2.stats.disk_hits == 4
    # the other package writes the same files, byte for byte
    d3 = r.d.Dispatcher([fast_backend()], cache=dict(disk_dir=tmp_path / "b"))
    run(calls(d3))
    files_a = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert files_a == sorted(p.name for p in (tmp_path / "b").iterdir())
    for name in files_a:
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
