"""The port's tracing and metrics (``repro_torch.obs``) against
``repro.obs``: the copies behave alike, both engines record the same
spans and page metrics for the same burst, and one tracer entered in
both packages' contexts records the PopPy runtime and the port's engine
in one trace."""

import asyncio
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import PREFIX, build_pair  # noqa: E402
from repro import obs as obs_jax  # noqa: E402
from repro.obs import spans as spans_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402


def _record(pkg, span_mod):
    """One call sequence through a package's tracer: nested context
    spans, an explicit parent, a detached span, an event, a retroactive
    record and maybe_span inside and outside tracing."""
    assert pkg.maybe_span("off") is pkg.maybe_span("off2")   # shared null
    with pkg.tracing() as trz:
        with trz.span("outer", cat="a", track="t1", n=1) as outer:
            with pkg.maybe_span("inner", cat="b", k="v"):
                trz.event("tick", cat="c", x=2)
            assert pkg.current_span() is outer
        sp = trz.begin("explicit", cat="d", parent=outer, track="t2")
        trz.end(sp, done=True)
        det = trz.begin("detached", parent=span_mod.DETACHED,
                        track="t3")
        trz.end(det)
        trz.record("phase", trz.now(), cat="e", parent=outer)
        try:
            with trz.span("fails"):
                raise KeyError("x")
        except KeyError:
            pass
    assert pkg.current_tracer() is None
    return trz


def _shape(trz):
    """Span fields that do not depend on the clock, in record order,
    with parents by name."""
    names = {s.span_id: s.name for s in trz.spans + trz.instants}
    return [(s.name, s.cat, s.track, names.get(s.parent_id), s.attrs,
             s.open) for s in trz.spans + trz.instants]


def test_tracer_and_spans_equal_reference():
    ref = _record(obs_jax, spans_jax)
    mine = _record(obs, spans)
    assert _shape(mine) == _shape(ref)
    assert [s.span_id for s in mine.spans] == [s.span_id for s in ref.spans]
    assert all(s.t1 >= s.t0 for s in mine.closed_spans())
    doc = obs.chrome_trace(mine)
    ref_doc = obs_jax.chrome_trace(ref)
    strip = [(e["ph"], e["name"], e.get("tid")) for e in doc["traceEvents"]]
    assert strip == [(e["ph"], e["name"], e.get("tid"))
                     for e in ref_doc["traceEvents"]]


def test_metrics_registry_equal_reference():
    regs = []
    for pkg in (obs_jax, obs):
        reg = pkg.MetricsRegistry()
        reg.counter("req").inc()
        reg.counter("req").inc(4)
        reg.counter("dom", domain="a").inc()
        g = reg.gauge("free")
        g.set(7)
        g.dec(3)
        g.inc()
        h = reg.histogram("lat", maxlen=3)
        for v in (0.004, 0.001, 0.003, 0.002):
            h.add(v)
        with pytest.raises(TypeError):
            reg.gauge("req")
        regs.append(reg)
    ref, mine = regs
    assert mine.snapshot() == ref.snapshot()
    assert mine.render() == ref.render()


# ---------------------------------------------------------------------------
# the same burst through both engines


@pytest.fixture(scope="module")
def dense():
    return build_pair("stablelm-3b")


def _burst(engine, pkg):
    """A warmed shared prefix, then a fan-out that outgrows the page pool
    (a page fault, a reclaim and a stall) with chunked prefill."""
    async def go():
        await engine.warm_prefix(PREFIX)
        outs = await asyncio.gather(*[
            engine.generate(PREFIX + list(range(100 + i, 120 + i)),
                            max_new_tokens=8) for i in range(4)])
        await engine.stop()
        return outs

    with pkg.tracing() as trz:
        outs = asyncio.run(go())
    return outs, trz


def _structure(trz):
    names = {s.span_id: s.name for s in trz.spans + trz.instants}
    return Counter((s.name, s.cat, s.track, names.get(s.parent_id))
                   for s in trz.spans + trz.instants)


def test_engine_spans_and_page_metrics_equal_reference(dense):
    _, mj, params_j, mt, params_t = dense
    kw = dict(max_slots=4, max_len=64, page_size=16, num_pages=8,
              prefill_chunk=8)
    ej = JaxEngine(mj, params_j, **kw)
    et = ServingEngine(mt, params_t, device="cpu", **kw)
    want, trz_j = _burst(ej, obs_jax)
    got, trz_t = _burst(et, obs)
    assert got == want
    assert et.admit_stalls > 0 and et.allocator.page_faults > 0
    assert _structure(trz_t) == _structure(trz_j)
    names = Counter(s.name for s in trz_t.spans + trz_t.instants)
    for name in ("request", "warm_prefix", "prefill.chunk", "admit",
                 "page.fill", "page.alloc", "page.stall", "page.reclaim",
                 "page.gather", "decode.step"):
        assert names[name] > 0, name
    assert names["decode.step"] == et.steps == ej.steps
    assert not any(s.open for s in trz_t.spans)
    snap_j, snap_t = ej.metrics.snapshot(), et.metrics.snapshot()
    page = {k: v for k, v in snap_t.items() if k.startswith("serving_page")}
    assert len(page) == 4
    assert page == {k: v for k, v in snap_j.items()
                    if k.startswith("serving_page")}
    assert page["serving_page_fault"] == et.allocator.page_faults


def test_one_tracer_records_runtime_and_port_engine(dense):
    """A ``repro.obs.Tracer`` entered in both packages' contexts around a
    PopPy program on ``LocalEngineBackend``: the runtime's spans and the
    port engine's spans land in one trace, the engine's requests nested
    under the runtime's calls."""
    from repro.core import poppy
    from repro.core.ai import llm, use_backend
    from repro.serving.backend import LocalEngineBackend

    _, _, _, mt, params_t = dense
    engine = ServingEngine(mt, params_t, max_slots=4, max_len=64,
                           device="cpu")

    @poppy
    def fanout(n):
        outs = tuple()
        for i in range(n):
            outs += (llm(f"prompt {i}", max_tokens=4),)
        return outs

    trz = obs_jax.Tracer()
    with use_backend(LocalEngineBackend(engine)), \
            obs_jax.tracing(trz), obs.tracing(trz):
        outs = fanout(3)
    assert len(outs) == 3
    by_id = {s.span_id: s for s in trz.spans}
    requests = [s for s in trz.spans if s.name == "request"]
    assert len(requests) == 3
    steps = [s for s in trz.spans if s.name == "decode.step"]
    assert len(steps) == engine.steps and all(s.parent_id == 0
                                              for s in steps)
    runtime = {s.name for s in trz.spans if not s.cat.startswith("serving")}
    assert runtime, "no runtime span recorded"
    for r in requests:
        parent = by_id[r.parent_id]
        assert not parent.cat.startswith("serving"), parent
    assert not any(s.open for s in trz.spans)
