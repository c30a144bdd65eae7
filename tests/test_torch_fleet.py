"""The port's replica fleet (``repro_torch.serving.fleet.EngineFleet``),
its serving backend and fault injection, against the reference's: the
cases of ``test_fleet.py`` on both packages' routers and on the port's
fleet; the port's fleet against the JAX fleet on the same (converted)
parameters, directly and under a PopPy program; the cases of
``test_durability.py`` that go through ``Dispatcher`` or
``LocalEngineBackend``; and the serving launcher."""

import asyncio
import json
import types

import jax
import numpy as np
import pytest
import torch

import repro.core.ai as ai_ref
import repro.dispatch as dispatch_ref
import repro.dispatch.stats as stats_ref
import repro.durability.faults as faults_ref
import repro.serving as serving_ref
import repro_torch.dispatch as dispatch_port
import repro_torch.dispatch.stats as stats_port
import repro_torch.durability.faults as faults_port
import repro_torch.serving as serving_port
import repro_torch.serving.fleet as fleet_port
from repro.configs import get_config as get_config_jax
from repro.core import batching, poppy
from repro.core.ai import SimulatedBackend, llm
from repro.models import build_model as build_jax
from repro_torch.configs import get_config
from repro_torch.dispatch.reliability import (BreakerPolicy, CircuitBreaker,
                                              CircuitOpenError)
from repro_torch.models import build_model
from repro_torch.models.convert import from_jax

# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

PACKAGES = {
    "reference": types.SimpleNamespace(d=dispatch_ref, stats=stats_ref),
    "port": types.SimpleNamespace(d=dispatch_port, stats=stats_port),
}


@pytest.fixture(params=list(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def run(coro):
    return asyncio.run(coro)


class WarmBackend:
    """Stub backend with a programmable prefix digest."""

    def __init__(self, depths=None):
        self.depths = depths or {}

    def prefix_probe(self, hint):
        return self.depths.get(hint, 0)


class BrokenDigestBackend:
    def prefix_probe(self, hint):
        raise RuntimeError("digest exploded")


# -- prefix-affinity policy ---------------------------------------------------


def test_affinity_routes_to_warmest_replica(pkg):
    cold, warm, warmer = (WarmBackend(), WarmBackend({"s1": 8}),
                          WarmBackend({"s1": 32}))
    r = pkg.d.make_router([cold, warm, warmer], policy="prefix_affinity")
    assert r.pick("s1").backend is warmer
    r.pick("s1").begin()
    assert r.pick("s1").backend is warmer


def test_affinity_cold_falls_back_to_least_outstanding(pkg):
    backends = [WarmBackend(), WarmBackend()]
    r = pkg.d.make_router(backends, policy="prefix_affinity")
    first = r.pick("never-seen")
    first.begin()
    assert r.pick("never-seen").backend is not first.backend
    assert isinstance(r, pkg.d.PrefixAffinityRouter)
    assert r.pick(None) is not None


def test_affinity_min_match_threshold(pkg):
    shallow = WarmBackend({"s1": 4})
    idle = WarmBackend()
    r = pkg.d.make_router([shallow, idle], policy="prefix_affinity",
                          min_match=8)
    r.replicas[0].begin()
    assert r.pick("s1").backend is idle


def test_affinity_overload_spill(pkg):
    warm = WarmBackend({"s1": 16})
    cold = WarmBackend()
    r = pkg.d.make_router([warm, cold], policy="prefix_affinity",
                          overload_slack=1)
    r.replicas[0].begin()
    assert r.pick("s1").backend is warm
    r.replicas[0].begin()
    assert r.pick("s1").backend is cold


def test_affinity_tie_breaks_by_load_then_wrr(pkg):
    a, b = WarmBackend({"s1": 16}), WarmBackend({"s1": 16})
    r = pkg.d.make_router([a, b], policy="prefix_affinity")
    r.replicas[0].begin()
    assert r.pick("s1").backend is b
    r.replicas[0].end()
    assert {r.pick("s1").backend for _ in range(2)} == {a, b}


def test_affinity_broken_digest_never_fails_routing(pkg):
    r = pkg.d.make_router([BrokenDigestBackend(), WarmBackend({"s1": 8})],
                          policy="prefix_affinity")
    assert r.pick("s1").backend is r.replicas[1].backend
    r2 = pkg.d.make_router([BrokenDigestBackend(), BrokenDigestBackend()],
                           policy="prefix_affinity")
    assert r2.pick("s1") is not None


# -- make_router validation ---------------------------------------------------

POLICIES = ["weighted", "least_outstanding", "prefix_affinity"]


@pytest.mark.parametrize("policy", POLICIES)
def test_make_router_rejects_weight_length_mismatch(pkg, policy):
    with pytest.raises(ValueError, match="len\\(weights\\) must match"):
        pkg.d.make_router(["a", "b", "c"], policy=policy, weights=[1, 2])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("bad", [[1, 0], [1, -2.5]])
def test_make_router_rejects_nonpositive_weights(pkg, policy, bad):
    with pytest.raises(ValueError, match="weights must be positive"):
        pkg.d.make_router(["a", "b"], policy=policy, weights=bad)


def test_make_router_rejects_name_length_mismatch(pkg):
    with pytest.raises(ValueError, match="len\\(names\\) must match"):
        pkg.d.make_router(["a", "b"], names=["only-one"])


def test_make_router_rejects_unknown_policy_kwargs(pkg):
    with pytest.raises(TypeError):
        pkg.d.make_router(["a"], policy="weighted", min_match=2)


# -- per-replica route counters ----------------------------------------------


def test_note_route_counters_and_snapshot(pkg):
    st = pkg.stats.DispatchStats()
    st.note_route("r0", matched=12)
    st.note_route("r0", matched=0)
    st.note_route("r0", matched=None)
    snap = st.snapshot()["backends"]["r0"]
    assert snap["routed"] == 3
    assert snap["prefix_probed"] == 2
    assert snap["prefix_hits"] == 1
    assert snap["prefix_hit_tokens"] == 12
    assert "affinity 1/2 warm (12 tok)" in st.report()


def test_dispatcher_records_per_replica_routes(pkg):
    class CountingBackend(WarmBackend):
        async def generate(self, prompt, *, max_tokens, temperature,
                           stop):
            return f"out:{prompt}"

    warm = CountingBackend({"s1:q": 6})
    cold = CountingBackend()
    d = pkg.d.Dispatcher([warm, cold], policy="prefix_affinity",
                         names=["warm", "cold"])
    assert run(d.generate("s1:q", max_tokens=4, temperature=0.0,
                          stop=None)) == "out:s1:q"
    snap = d.stats.snapshot()["backends"]
    assert snap["warm"]["routed"] == 1
    assert snap["warm"]["prefix_hits"] == 1
    assert snap["warm"]["prefix_hit_tokens"] == 6
    assert snap.get("cold", {}).get("routed", 0) == 0


# -- EngineFleet end-to-end ---------------------------------------------------

TINY = dict(num_layers=1, d_model=64, num_heads=4, head_dim=16, d_ff=128)


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, JAX params, port model, port params): the reference's
    tiny stablelm of ``test_fleet.py``, its init converted to the port."""
    mj = build_jax(get_config_jax("stablelm-3b").reduced().replace(**TINY))
    pj = mj.init(jax.random.PRNGKey(3))
    mt = build_model(get_config("stablelm-3b").reduced().replace(**TINY))
    pt = from_jax(mt.cfg, jax.tree.map(np.asarray, pj), device="cpu")
    return mj, pj, mt, pt


def test_fleet_validation(tiny, monkeypatch):
    _, _, model, params = tiny
    EngineFleet = serving_port.EngineFleet
    with pytest.raises(ValueError, match="replicas"):
        EngineFleet(model, params, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="tp"):
        EngineFleet(model, params, tp=0, device="cpu")
    with pytest.raises(RuntimeError, match="devices"):
        EngineFleet(model, params, tp=2, device="cpu")
    # enough devices: each replica spans its own tensor-parallel mesh
    fleet = EngineFleet(model, params, replicas=2, tp=2,
                        devices=["cpu"] * 4, device="cpu")
    assert [e.mesh.shape for e in fleet.engines] == [
        {"data": 1, "model": 2}] * 2


def test_fleet_default_device_needs_a_gpu(tiny, monkeypatch):
    _, _, model, params = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serving_port.EngineFleet(model, params, replicas=2)


PROMPTS = [f"session {i % 2}: question {i}" for i in range(6)]


def _fleet_outputs(fleet, prompts):
    async def routed():
        outs = await asyncio.gather(*(
            fleet.dispatcher.generate(p, max_tokens=6, temperature=0.0,
                                      stop=None) for p in prompts))
        await fleet.stop()
        return list(outs)
    return run(routed())


def test_fleet_tokens_match_single_engine(tiny):
    _, _, model, params = tiny
    tok = serving_port.ByteTokenizer(model.cfg.vocab_size)
    single = serving_port.ServingEngine(model, params, max_slots=4,
                                        max_len=64, device="cpu")

    async def ref():
        outs = await asyncio.gather(*(
            single.generate(tok.encode(p), max_new_tokens=6,
                            temperature=0.0) for p in PROMPTS))
        await single.stop()
        return [tok.decode(o) for o in outs]

    expected = run(ref())
    fleet = serving_port.EngineFleet(model, params, replicas=2, max_slots=4,
                                     max_len=64, device="cpu")
    assert _fleet_outputs(fleet, PROMPTS) == expected
    snap = fleet.stats.snapshot()["backends"]
    assert sum(b["routed"] for b in snap.values()) == len(PROMPTS)
    assert all(b["routed"] > 0 for b in snap.values())
    assert fleet.engine_stats().keys() == {"replica0", "replica1"}


def _tokens(tok, outs):
    return [tok.encode(o) for o in outs]


@pytest.mark.parametrize("policy", ["prefix_affinity", "least_outstanding"])
def test_fleet_tokens_match_jax_fleet(tiny, policy):
    """The port's two-replica fleet returns the JAX fleet's greedy tokens,
    exactly, and routes the same requests to the same replicas."""
    mj, pj, mt, pt = tiny
    kw = dict(replicas=2, policy=policy, max_slots=4, max_len=64)
    fj = serving_ref.EngineFleet(mj, pj, **kw)
    ft = serving_port.EngineFleet(mt, pt, device="cpu", **kw)
    tok = serving_port.ByteTokenizer(mt.cfg.vocab_size)
    want = _fleet_outputs(fj, PROMPTS)
    got = _fleet_outputs(ft, PROMPTS)
    assert _tokens(tok, got) == _tokens(tok, want)
    routed = {n: b["routed"] for n, b in
              ft.stats.snapshot()["backends"].items()}
    assert routed == {n: b["routed"] for n, b in
                      fj.stats.snapshot()["backends"].items()}


SHARED = "shared system context for every question; " * 2


@poppy
def shared_prefix_app(n):
    outs = tuple()
    for i in range(n):
        outs += (llm(SHARED + f"question {i}", max_tokens=6),)
    return outs


def test_poppy_program_through_port_fleet_matches_jax_fleet(tiny):
    """A PopPy program whose calls batch (``batching()``) gives the same
    tokens and the same shared-prefix batch counts routed through the
    port's fleet as through the JAX fleet: the port's dispatcher binds
    itself where the port's backend reads its stats."""
    mj, pj, mt, pt = tiny
    kw = dict(replicas=2, max_slots=4, max_len=128)
    results = {}
    for name, fleet in (
            ("jax", serving_ref.EngineFleet(mj, pj, **kw)),
            ("port", serving_port.EngineFleet(mt, pt, device="cpu", **kw))):
        with ai_ref.use_dispatcher(fleet.dispatcher), batching():
            outs = shared_prefix_app(4)
        results[name] = (outs, fleet.stats.snapshot()["prefix"])
    tok = serving_port.ByteTokenizer(mt.cfg.vocab_size)
    (outs_j, prefix_j), (outs_t, prefix_t) = results["jax"], results["port"]
    assert _tokens(tok, outs_t) == _tokens(tok, outs_j)
    assert prefix_j["batches"] == 1 and prefix_j["elements"] == 4
    assert prefix_j["shared_tokens"] > 0
    assert prefix_t == prefix_j


def test_prefix_batch_stats_flow_to_port_dispatcher(tiny):
    """The reference's ``test_prefix_batch_stats_flow_to_dispatcher`` on
    the port: a backend called under the port's ``use_dispatcher``."""
    from repro_torch.core.ai import use_dispatcher
    _, _, mt, pt = tiny
    engine = serving_port.ServingEngine(mt, pt, max_slots=4, max_len=96,
                                        device="cpu")
    backend = serving_port.LocalEngineBackend(engine)
    d = dispatch_port.Dispatcher()
    prompts = ["shared prefix text " + s for s in ("one", "two", "three")]

    async def go():
        with use_dispatcher(d):
            outs = await backend.generate_batch(
                prompts, max_tokens=4, temperature=0.0, stop=None)
        await engine.stop()
        return outs

    assert len(run(go())) == 3
    snap = d.stats.snapshot()["prefix"]
    assert snap["batches"] == 1 and snap["elements"] == 3
    assert snap["shared_tokens"] > 0
    assert snap["computed_tokens"] == snap["shared_tokens"]
    assert "shared-prefix batches" in d.stats.report()


def test_common_prefix_len_matches_reference():
    from repro.serving.backend import common_prefix_len as ref
    cases = [[[1, 2, 3], [1, 2, 9], [1, 2]], [[1], [2]], [], [[5, 6]],
             [[7, 7, 7], [7, 7, 7]]]
    for c in cases:
        assert serving_port.common_prefix_len(c) == ref(c)


# -- fault injection and breakers (test_durability.py's dispatch cases) ------


def test_breaker_transitions():
    now = [0.0]
    seen = []
    br = CircuitBreaker(BreakerPolicy(failure_threshold=2, cooldown_s=10.0),
                        name="b", clock=lambda: now[0],
                        on_transition=lambda *a: seen.append(a))
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and not br.allow()
    now[0] = 9.9
    assert not br.allow()
    now[0] = 10.1
    assert br.allow()
    assert br.state == "half_open"
    assert not br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    now[0] = 20.2
    assert br.allow()
    br.record_failure()
    assert br.state == "open"
    states = [state for _, state in seen]
    assert "open" in states and "half_open" in states and "closed" in states


def test_breaker_success_resets_failure_streak():
    br = CircuitBreaker(BreakerPolicy(failure_threshold=3, cooldown_s=1.0))
    for _ in range(5):
        br.record_failure()
        br.record_failure()
        br.record_success()
    assert br.state == "closed"


def test_dispatcher_breaker_fastfails_and_recovers():
    fi = faults_port.FaultInjector(faults_port.FaultPlan(error_rate=1.0,
                                                         seed=3))
    d = dispatch_port.Dispatcher([SimulatedBackend(time_scale=0.01)],
                                 breaker=BreakerPolicy(failure_threshold=3,
                                                       cooldown_s=0.05),
                                 faults=fi)
    kw = dict(max_tokens=4, temperature=0.0, stop=None)

    async def go():
        for i in range(5):
            with pytest.raises((faults_port.InjectedFault,
                                CircuitOpenError)):
                await d.generate(f"p{i}", **kw)
        assert d.stats.breaker_opens >= 1
        assert d.stats.breaker_fastfails >= 1
        fi.plan = faults_port.FaultPlan()
        await asyncio.sleep(0.06)
        assert await d.generate("healed", **kw)
        assert d.stats.breaker_probes >= 1
        assert d.stats.breaker_closes >= 1
        for r in d.router.replicas:
            assert r.outstanding == 0

    run(go())


def test_fault_plan_validation():
    FaultPlan, make_injector = faults_port.FaultPlan, faults_port.make_injector
    with pytest.raises(ValueError):
        FaultPlan(error_rate=1.5)
    with pytest.raises(ValueError):
        FaultPlan(timeout_rate=-0.1)
    with pytest.raises(TypeError):
        make_injector(42)
    # the port takes its own types only: a reference plan is refused
    with pytest.raises(TypeError, match="FaultPlan"):
        make_injector(faults_ref.FaultPlan(error_rate=0.5))
    assert make_injector(None) is None
    assert isinstance(make_injector({"error_rate": 0.5}),
                      faults_port.FaultInjector)


def _schedule(faults, seed):
    fi = faults.FaultInjector(faults.FaultPlan(error_rate=0.3,
                                               timeout_rate=0.2,
                                               timeout_s=0.0, seed=seed))

    async def go():
        out = []
        for _ in range(30):
            try:
                await fi.perturb("b0")
                out.append("ok")
            except faults.InjectedTimeout:
                out.append("timeout")
            except faults.InjectedFault:
                out.append("error")
        return out

    return run(go())


def test_fault_injection_is_seeded_deterministic():
    a, b, c = (_schedule(faults_port, 7), _schedule(faults_port, 7),
               _schedule(faults_port, 8))
    assert a == b and a != c
    assert "error" in a and "ok" in a
    # and the port draws the reference's schedule, fault for fault
    assert a == _schedule(faults_ref, 7)
    assert c == _schedule(faults_ref, 8)


def test_disk_cache_corruption_is_counted_miss(tmp_path):
    kw = dict(max_tokens=4, temperature=0.0, stop=None)

    def dispatcher():
        return dispatch_port.Dispatcher([SimulatedBackend(time_scale=0.01)],
                                        cache=dict(disk_dir=tmp_path))

    d1 = dispatcher()
    v1 = run(d1.generate("keep me", **kw))
    files = list(tmp_path.glob("*.json"))
    assert files
    for f in files:
        f.write_text("{ torn json")
    d2 = dispatcher()
    assert run(d2.generate("keep me", **kw)) == v1
    assert d2.stats.disk_corrupt == 1 and d2.stats.disk_hits == 0
    rebuilt = list(tmp_path.glob("*.json"))
    assert rebuilt and json.loads(rebuilt[0].read_text())["value"]
    d3 = dispatcher()
    assert run(d3.generate("keep me", **kw)) == v1
    assert d3.stats.disk_hits == 1 and d3.stats.disk_corrupt == 0


def test_engine_backend_fault_never_reaches_the_engine(tiny):
    """An injected failure raises before the request touches the engine,
    so it leaks no slot, page or prefix pin; a retrying dispatcher over
    the faulty backend still answers once the plan heals."""
    _, _, mt, pt = tiny
    engine = serving_port.ServingEngine(mt, pt, max_slots=2, max_len=64,
                                        device="cpu")
    backend = serving_port.LocalEngineBackend(
        engine, faults={"error_rate": 1.0, "seed": 1}, name="r0")
    kw = dict(max_tokens=4, temperature=0.0, stop=None)
    with pytest.raises(faults_port.InjectedFault, match="r0"):
        run(backend.generate("hello", **kw))
    assert engine.steps == 0 and engine.free_slots == [0, 1]
    assert backend.faults.injected == 1
    backend.faults.plan = faults_port.FaultPlan()

    async def healed():
        out = await backend.generate("hello", **kw)
        await engine.stop()
        return out

    assert isinstance(run(healed()), str)
    assert sorted(engine.free_slots) == [0, 1]


# -- the serving launcher -----------------------------------------------------


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--replicas", "2", "--requests", "4",
          "--max-new-tokens", "4"])
    out = capsys.readouterr().out
    assert "4 requests in" in out and "over 2 replica(s)" in out
    assert sum(line.startswith("req ") for line in out.splitlines()) == 4
    assert "replica0" in out and "replica1" in out


def test_serve_launcher_default_device_needs_a_gpu(monkeypatch):
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--replicas", "2", "--requests", "4"])
