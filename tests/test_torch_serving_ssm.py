"""The port's contiguous serving engine for the Mamba-2 SSM against the
JAX engine.

An SSM's state cannot be cut by position, so both engines take the
contiguous layout: one exact-length prefill per admission, its SSM state
and conv history copied whole into a slot, and batched
``Model.decode_step``.  Both serve ``mamba2-2.7b.reduced()`` (2 SSD
blocks, chunk 8) on the same parameters; greedy tokens must be *equal*
for prompts of 3 or more tokens.  For 1- and 2-token prompts the JAX
engine shifts the conv history (``ROADMAP.md`` §D), so the port is held
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

from helpers_torch import build_pair  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

KW = dict(max_slots=3, max_len=40)
# >= 3 tokens, where the JAX engine is exact: ragged (3, 13) and chunk
# multiples (8, 16) of the 8-step chunk
PROMPTS = [[5, 17, 31], list(range(1, 14)), [42, 5, 6, 7, 8, 9, 10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]]
MAX_NEW = 8


@pytest.fixture(scope="module")
def served():
    return build_pair("mamba2-2.7b")


async def _serve(engine, prompts, max_new):
    outs = await asyncio.gather(*[
        engine.generate(p, max_new_tokens=max_new) for p in prompts])
    await engine.stop()
    return outs


def test_greedy_tokens_equal_jax_engine(served):
    """Four concurrent requests on three slots: the last one is admitted
    into a slot a finished request left, whose state it replaces whole."""
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
    assert max(et.batch_occupancy) == 3
    assert sorted(et.free_slots) == [0, 1, 2] and not et.active
    ssm = et.cache["layers"]["b0"]["ssm"]
    assert tuple(ssm.shape) == (2, 3, 8, 16, 16)


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
    got = asyncio.run(_serve(et, [prompt], 5))[0]
    assert got == _greedy_forward(mj, params_j, prompt, 5)
