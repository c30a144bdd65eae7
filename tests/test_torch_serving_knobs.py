"""The reference engine's knobs on the port's engine, against the JAX
engine on the same parameters: ``eos_token``, ``prefill_buckets``,
``idle_quiesce_s``, ``step_sleep`` and ``name``.  Each runs on reduced
stablelm-3b (paged) and on reduced recurrentgemma-9b (contiguous,
exact-length admission), on the CPU."""

import asyncio
import time
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import HYBRID, build_pair  # noqa: E402
from repro import obs as obs_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

MODELS = {"dense": ("stablelm-3b", {}), "hybrid": ("recurrentgemma-9b",
                                                   HYBRID)}
KW = dict(max_slots=2, max_len=64)
PROMPTS = [[5, 17, 31], list(range(3, 23)), [42, 5, 6, 7, 8]]
MAX_NEW = 8


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    name, replace = MODELS[request.param]
    return build_pair(name, **replace)


async def _serve(engine, prompts=PROMPTS, max_new=MAX_NEW):
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


def _engines(pair, **kw):
    _, mj, params_j, mt, params_t = pair
    return (JaxEngine(mj, params_j, **KW, **kw),
            ServingEngine(mt, params_t, device="cpu", **KW, **kw))


def _eos(pair):
    """A token the JAX engine's greedy output emits mid-sequence retires
    the request there in both engines."""
    want_full = asyncio.run(_serve(_engines(pair)[0]))
    eos = want_full[0][3]
    ej, et = _engines(pair, eos_token=eos)
    want, got = asyncio.run(_serve(ej)), asyncio.run(_serve(et))
    assert got == want
    assert len(got[0]) == want_full[0].index(eos) + 1 < MAX_NEW
    assert all(o[-1] == eos or len(o) == MAX_NEW for o in got)


def _buckets(pair):
    """Custom pad-to lengths, given unsorted: the same tokens and the same
    prefill shapes (exact-length admission ignores them)."""
    ej, et = _engines(pair, prefill_buckets=(64, 16, 32), prefill_chunk=8)
    want, got = asyncio.run(_serve(ej)), asyncio.run(_serve(et))
    assert got == want
    assert et.prefill_shapes == ej.prefill_shapes
    assert et.stats()["prefill_buckets"] == ej.stats()["prefill_buckets"]
    if et.paged_kv:
        assert et.stats()["prefill_buckets"] == [16, 32, 64]


def _buckets_off_page(pair):
    """A bucket that is not a multiple of ``page_size`` is refused on the
    paged layout, by both engines alike; exact-length admission ignores
    it."""
    kw = dict(prefill_buckets=(24, 64), page_size=16)
    _, mj, params_j, mt, params_t = pair
    try:
        JaxEngine(mj, params_j, **KW, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="not multiples of page_size"):
            ServingEngine(mt, params_t, device="cpu", **KW, **kw)
        assert "not multiples of page_size" in str(e)
        assert mt.prefix_seq_axes() is not None
        return
    et = ServingEngine(mt, params_t, device="cpu", **KW, **kw)
    assert et.stats()["prefill_buckets"] == []


def _idle_quiesce(pair):
    """Both loops return after ``idle_quiesce_s`` idle seconds, well before
    the default second."""
    async def go(engine):
        await engine.generate(PROMPTS[0], max_new_tokens=2)
        t0 = time.monotonic()
        await asyncio.wait_for(asyncio.shield(engine._task), 5.0)
        return time.monotonic() - t0

    for engine in _engines(pair, idle_quiesce_s=0.05):
        waited = asyncio.run(go(engine))
        assert 0.04 <= waited < 0.6 and engine._task.done()


def _sleep_and_name(pair):
    """A named engine with ``step_sleep`` labels every scheduler track
    ``r1:``; the spans equal the JAX engine's by (name, cat, track)."""
    ej, et = _engines(pair, step_sleep=0.002, name="r1")
    runs = []
    for engine, pkg in ((ej, obs_jax), (et, obs)):
        with pkg.tracing() as trz:
            outs = asyncio.run(_serve(engine))
        runs.append((outs, Counter((s.name, s.cat, s.track)
                                   for s in trz.spans + trz.instants)))
    (want, spans_j), (got, spans_t) = runs
    assert got == want and spans_t == spans_j
    tracks = {t for _, _, t in spans_t} - {"main"}
    assert tracks and all(t.startswith("r1:") for t in tracks)
    assert spans_t[("decode.step", "serving.decode", "r1:decode")] \
        == et.steps


KNOBS = {"eos_token": _eos, "prefill_buckets": _buckets,
         "prefill_buckets_off_page": _buckets_off_page,
         "idle_quiesce_s": _idle_quiesce, "step_sleep_and_name": _sleep_and_name}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_matches_jax_engine(pair, knob):
    KNOBS[knob](pair)
