"""The port's trace report (``repro_torch.obs.report`` and ``python -m
repro_torch.obs``) against ``repro.obs.report`` over the same spans.

The synthetic cases are those of ``tests/test_obs.py``: a sequential
chain, an unordered fan-out with idle, innermost attribution, render and
the empty run; then a trace of the port's own engine, exported and read
back by the CLI.
"""

import asyncio
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import obs as obs_jax  # noqa: E402
from repro.obs.spans import Span as SpanJax  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _span(name, cat, t0, t1, sid, parent=0, track="main", **attrs):
    return obs.Span(name=name, cat=cat, t0=t0, t1=t1, span_id=sid,
                    parent_id=parent, track=track, attrs=attrs)


def _jax(spans):
    return [SpanJax(**{f.name: getattr(s, f.name)
                       for f in dataclasses.fields(SpanJax)})
            for s in spans]


CASES = {
    "sequential_chain": [
        _span("run", "engine", 0.0, 8.5, 1),
        _span("a", "external", 0.0, 4.0, 2, parent=1,
              cls="sequential", effects=["m"], seq=0),
        _span("b", "external", 4.0, 8.0, 3, parent=1,
              cls="sequential", effects=["m"], seq=1),
    ],
    "unordered_fanout_and_idle": [
        _span("a", "external", 0.0, 3.0, 1, cls="unordered", effects=[]),
        _span("b", "external", 0.0, 4.0, 2, cls="unordered", effects=[]),
        _span("c", "external", 6.0, 7.0, 3, cls="unordered", effects=[]),
    ],
    "innermost_span": [
        _span("ext", "external", 0.0, 5.0, 1, cls="unordered", effects=[]),
        _span("call", "external.call", 1.0, 4.0, 2, parent=1),
    ],
    "readonly_window": [
        _span("w", "external", 0.0, 1.0, 1, cls="sequential",
              effects=["db"], seq=0),
        _span("r1", "external", 1.0, 3.0, 2, cls="readonly",
              effects=["db"], seq=1),
        _span("r2", "external", 1.0, 2.0, 3, cls="readonly",
              effects=["db"], seq=2),
        _span("w2", "external", 3.0, 4.5, 4, cls="sequential",
              effects=["db"], seq=3),
    ],
    "serving_only": [
        _span("request", "serving.request", 0.0, 2.0, 1),
        _span("decode.step", "serving.decode", 0.5, 0.75, 2, parent=1),
        _span("decode.step", "serving.decode", 1.0, 1.25, 3, parent=1),
    ],
    "render_single": [
        _span("x", "external", 0.0, 1.0, 1, cls="unordered", effects=[]),
    ],
    "empty": [],
}


def _summary(rep):
    return {
        "wall_s": rep.wall_s, "t0": rep.t0, "t1": rep.t1,
        "path": [(s.t0, s.t1, s.name, s.cat, s.track, s.span_id)
                 for s in rep.path],
        "components": {k: dataclasses.astuple(c)
                       for k, c in rep.components.items()},
        "busy": rep.busy_external_s, "ideal": rep.ideal_makespan_s,
        "n": (rep.n_spans, rep.n_externals),
        "attributed": rep.attributed_external_s, "idle": rep.idle_s,
        "par": (rep.achieved_parallelism, rep.ideal_parallelism,
                rep.parallel_efficiency),
        "blockers": [dataclasses.astuple(c) for c in rep.top_blockers()],
    }


@pytest.mark.parametrize("case", list(CASES))
def test_report_equals_reference(case):
    spans = CASES[case]
    got, want = obs.report(spans), obs_jax.report(_jax(spans))
    assert _summary(got) == _summary(want)
    if spans:
        assert got.render() == want.render()
        assert abs(sum(s.dur for s in got.path) - got.wall_s) < 1e-9


def test_report_cases_read_as_the_reference_tests_say():
    chain = obs.report(CASES["sequential_chain"])
    assert chain.wall_s == 8.5
    assert abs(chain.attributed_external_s - 8.0) < 1e-9
    assert abs(chain.parallel_efficiency - 8.0 / 8.5) < 1e-9
    fan = obs.report(CASES["unordered_fanout_and_idle"])
    assert abs(fan.idle_s - 2.0) < 1e-9
    assert abs(fan.ideal_makespan_s - 4.0) < 1e-9
    assert ("", "idle") in {(c.cat, c.name) for c in fan.top_blockers()}
    inner = obs.report(CASES["innermost_span"])
    assert abs(inner.components[("external.call", "call")].critical_s
               - 3.0) < 1e-9
    assert abs(inner.busy_external_s - 3.0) < 1e-9
    empty = obs.report([])
    assert empty.wall_s == 0.0 and empty.path == []
    text = obs.report(CASES["render_single"]).render()
    assert "critical path" in text and "external:x" in text


def test_report_exports():
    for name in ("report", "RunReport", "Segment", "Component"):
        assert name in obs.__all__ and hasattr(obs, name)
    assert obs.report(obs.Tracer()).n_spans == 0


def _engine_trace():
    cfg = get_config("stablelm-3b").reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    engine = ServingEngine(model, params, max_slots=2, max_len=64,
                           device="cpu")

    async def go():
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=3) for p in ([5, 6, 7], [9])])
        await engine.stop()
        return outs

    with obs.tracing() as trz:
        asyncio.run(go())
    return trz


def test_engine_trace_report_and_cli(tmp_path):
    """A traced run of the port's engine: the report's segments sum to
    the wall time, equal the reference's over the same spans, and the CLI
    prints the same report from the exported trace."""
    trz = _engine_trace()
    rep = obs.report(trz)
    assert rep.n_spans > 0
    assert abs(sum(s.dur for s in rep.path) - rep.wall_s) < 1e-9
    assert _summary(rep) == _summary(obs_jax.report(
        _jax(trz.closed_spans())))
    path = tmp_path / "run.json"
    obs.write_chrome_trace(str(path), trz)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", str(path), "--timeline"],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 0, run.stderr
    assert obs.report(obs.load_spans(str(path))).render() in run.stdout
    assert "critical path" in run.stdout


def test_cli_on_an_empty_trace(tmp_path):
    path = tmp_path / "empty.json"
    path.write_text('{"traceEvents": []}')
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", str(path)],
        capture_output=True, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert run.returncode == 1
    assert "no complete spans" in run.stdout
