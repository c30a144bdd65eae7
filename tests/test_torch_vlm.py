"""The port's VLM (pixtral-12b: a dense GQA decoder with a ``patch_stub``
front end) against the JAX package.

JAX initializes reduced pixtral-12b (float32), the tree goes to the port
through ``convert.from_jax``, and the same numpy tokens and patch
embeddings run through both: logits at rtol = atol = 1e-4 (the tolerance
of ``tests/test_torch_models.py``).  Text requests go through both paged
engines, whose greedy tokens must be equal.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from helpers_torch import SCENARIOS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
N_PATCHES = 4


@pytest.fixture(scope="module")
def pixtral():
    cfg_j = get_config_jax("pixtral-12b").reduced()
    cfg = get_config("pixtral-12b").reduced()
    mj = build_jax(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(13))
    mt = build_model(cfg)
    params_t = from_jax(cfg, jax.tree.map(np.asarray, params_j),
                        device="cpu")
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    patches = (0.02 * rng.randn(2, N_PATCHES, cfg.d_model)).astype(
        np.float32)
    return cfg, mj, params_j, mt, params_t, tokens, patches


def t(x):
    return torch.tensor(np.asarray(x))


def test_vlm_takes_the_paged_layout(pixtral):
    cfg, _, _, mt, _, _, _ = pixtral
    assert cfg.frontend == "patch_stub"
    assert mt.prefix_seq_axes() == {"k": 2, "v": 2}
    assert not lm.is_contiguous(cfg)


def test_patch_embeds_replace_the_first_token_embeddings(pixtral):
    cfg, _, _, _, params_t, tokens, patches = pixtral
    batch = {"tokens": t(tokens), "patch_embeds": t(patches)}
    h, pos = lm.embed_inputs(cfg, params_t, batch)
    text, pos0 = lm.embed_inputs(cfg, params_t, {"tokens": t(tokens)})
    assert torch.equal(h[:, :N_PATCHES], t(patches))
    assert torch.equal(h[:, N_PATCHES:], text[:, N_PATCHES:])
    assert torch.equal(pos, pos0)
    # a text-only model ignores patch embeddings, as the reference does
    dense = cfg.replace(frontend="")
    h2, _ = lm.embed_inputs(dense, params_t, batch)
    assert torch.equal(h2, text)


@pytest.mark.parametrize("with_patches", [False, True])
def test_forward_matches(pixtral, with_patches):
    cfg, mj, params_j, mt, params_t, tokens, patches = pixtral
    bj, bt = {"tokens": jnp.asarray(tokens)}, {"tokens": t(tokens)}
    if with_patches:
        bj["patch_embeds"] = jnp.asarray(patches)
        bt["patch_embeds"] = t(patches)
    lj, _ = mj.forward(params_j, bj)
    with torch.no_grad():
        lt, _ = mt.forward(params_t, bt)
    v = cfg.vocab_size
    np.testing.assert_allclose(lt[..., :v].numpy(), np.asarray(lj)[..., :v],
                               **TOL)


def test_prefill_with_patches_matches(pixtral):
    """Prefill with 4 patch embeddings ahead of the text: the last
    logits and the K/V."""
    cfg, mj, params_j, mt, params_t, tokens, patches = pixtral
    cap, v = 16, cfg.vocab_size
    lj, cache_j = mj.prefill(params_j, {"tokens": jnp.asarray(tokens),
                                        "patch_embeds": jnp.asarray(patches)},
                             cap)
    with torch.no_grad():
        lt, cache_t = mt.prefill(params_t, {"tokens": t(tokens),
                                            "patch_embeds": t(patches)}, cap)
    np.testing.assert_allclose(lt[:, :v].numpy(), np.asarray(lj)[:, :v],
                               **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(
            cache_t[n].numpy(), np.asarray(cache_j["layers"]["b0"][n]), **TOL)
    # the patches changed the text's logits
    with torch.no_grad():
        text, _ = mt.prefill(params_t, {"tokens": t(tokens)}, cap)
    assert not torch.allclose(text, lt, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["concurrent", "shared_prefix"])
def test_greedy_tokens_equal_jax_engine(pixtral, name):
    _, mj, params_j, mt, params_t, _, _ = pixtral
    kw, prompts, max_new, warm = SCENARIOS[name]

    async def serve(engine):
        if warm is not None:
            await engine.warm_prefix(warm)
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new) for p in prompts])
        await engine.stop()
        return outs

    ej = JaxEngine(mj, params_j, **kw)
    et = ServingEngine(mt, params_t, device="cpu", **kw)
    want = asyncio.run(serve(ej))
    got = asyncio.run(serve(et))
    assert got == want
    st = et.stats()
    assert st["kv_layout"] == "paged" and st["kv_admit_copies"] == 0
    if name == "shared_prefix":
        assert st["prefill_tokens_reused"] == ej.prefill_tokens_reused > 0
