"""The port's contiguous serving engine against the JAX engine.

Models whose cache cannot be cut by position (hybrid RG-LRU/local
attention, int8 KV) take the contiguous layout: one exact-length prefill
per admission, copied into a slot of one ``[.., max_slots, C, ..]``
cache, and batched ``Model.decode_step``.  Both engines serve
``recurrentgemma-9b.reduced()`` (5 layers, window 8, so long prompts roll
the ring and decode wraps it) on the same parameters; greedy tokens must
be *equal*.  For prompts shorter than the conv history (1-2 tokens) the
JAX engine shifts the conv state (``ROADMAP.md`` §D), so the port is held
against greedy decoding by the JAX ``forward`` there.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import HYBRID, build_pair  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

KW = dict(max_slots=2, max_len=32)
# ≥ 3 tokens: the JAX engine is exact there; 11 and 14 exceed the window
PROMPTS = [[5, 17, 31], list(range(1, 12)), [42, 5, 6, 7, 8],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7]]
MAX_NEW = 10   # decode wraps the 8-slot ring for every prompt


@pytest.fixture(scope="module", params=["", "int8"], ids=["kv", "int8kv"])
def served(request):
    return build_pair("recurrentgemma-9b", kv_cache_dtype=request.param,
                      **HYBRID)


async def _serve(engine, prompts, max_new):
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


def test_greedy_tokens_equal_jax_engine(served):
    """More requests than slots, prompts inside and beyond the window."""
    _, mj, params_j, mt, params_t = served
    want = asyncio.run(_serve(JaxEngine(mj, params_j, **KW), PROMPTS,
                              MAX_NEW))
    et = ServingEngine(mt, params_t, device="cpu", **KW)
    got = asyncio.run(_serve(et, PROMPTS, MAX_NEW))
    assert got == want
    assert all(len(o) == MAX_NEW for o in got)
    st = et.stats()
    assert (st["kv_layout"], st["paged"], st["prefill_shape_bound"]) \
        == ("contiguous", False, None)
    assert st["kv_admit_copies"] == st["prefill_chunks"] == len(PROMPTS)
    assert st["prefill_tokens_computed"] == sum(map(len, PROMPTS))
    assert st["prefix_cache"] is None and max(et.batch_occupancy) == 2
    assert sorted(et.free_slots) == [0, 1] and not et.active


def _greedy_forward(mj, params_j, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = mj.forward(params_j,
                               {"tokens": jnp.asarray([toks], jnp.int32)})
        toks.append(int(np.asarray(logits)[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("prompt", [[5], [5, 17]], ids=["1tok", "2tok"])
def test_short_prompts_equal_greedy_forward(served, prompt):
    """Prompts shorter than conv_width - 1: the port's engine gives the
    tokens of greedy decoding by the reference's ``forward``."""
    _, mj, params_j, mt, params_t = served
    et = ServingEngine(mt, params_t, device="cpu", **KW)
    got = asyncio.run(_serve(et, [prompt], 6))[0]
    assert got == _greedy_forward(mj, params_j, prompt, 6)


def test_paged_model_keeps_contiguous_opt_out_raising():
    """``kv_layout="contiguous"`` for a model the paged layout serves (its
    prefix cache and splice) still raises; an unknown layout is refused."""
    _, _, _, mt, params_t = build_pair("stablelm-3b")
    with pytest.raises(NotImplementedError, match="contiguous"):
        ServingEngine(mt, params_t, device="cpu", kv_layout="contiguous")
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(mt, params_t, device="cpu", kv_layout="ring")


def test_cancelled_request_frees_its_slot(served):
    """A request dropped while it decodes gives its slot back; the
    survivors still get the JAX engine's tokens."""
    _, mj, params_j, mt, params_t = served

    async def go(engine):
        keep = [asyncio.create_task(engine.generate(p, max_new_tokens=6))
                for p in PROMPTS[:2]]
        drop = asyncio.create_task(engine.generate(PROMPTS[2],
                                                   max_new_tokens=20))
        await asyncio.sleep(0)
        drop.cancel()
        outs = await asyncio.gather(*keep)
        await asyncio.gather(drop, return_exceptions=True)
        await engine.stop()
        return outs

    want = asyncio.run(go(JaxEngine(mj, params_j, max_slots=3, max_len=32)))
    et = ServingEngine(mt, params_t, device="cpu", max_slots=3, max_len=32)
    assert asyncio.run(go(et)) == want
    assert sorted(et.free_slots) == [0, 1, 2] and not et.active
