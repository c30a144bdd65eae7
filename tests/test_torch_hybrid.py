"""The port's hybrid RG-LRU/local-attention LM and its contiguous cache
against the JAX package, on the same parameters.

Both run on the port's seeded parameters (handed to JAX with
``convert.to_numpy``), and the same numpy inputs run through both (JAX at its default
``attention_impl="xla"``, which ``tests/test_kernels.py`` shows equal to
the Pallas kernels).  The model is ``recurrentgemma-9b.reduced()`` with 5
layers — one (rglru, rglru, attn) super-block plus a two-block rglru tail
— and an attention window of 8, so prompts longer than the window roll
the ring buffer at prefill and decode wraps it.  Float32 logits agree to
rtol = atol = 1e-4 (XLA and PyTorch sum in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import HYBRID, assert_cache_close, build_pair  # noqa: E402
from repro.models import rglru as rglru_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module", params=["", "int8"], ids=["kv", "int8kv"])
def hybrid(request):
    return build_pair("recurrentgemma-9b", kv_cache_dtype=request.param,
                      **HYBRID)


def test_layer_grouping_is_the_reference(hybrid):
    from repro.models import lm as lm_jax
    from repro_torch.models import lm
    cfg, mj, _, mt, _ = hybrid
    assert lm.block_kinds(cfg) == lm_jax.block_kinds(mj.cfg)
    assert lm._layer_groups(cfg) == lm_jax._layer_groups(mj.cfg)
    assert mt.prefix_seq_axes() is None
    full = get_config("recurrentgemma-9b")
    kinds, n_groups, tail = lm._layer_groups(full)
    assert (len(kinds), n_groups, len(tail)) == (3, 12, 2)
    assert build_model(full).num_params() == 10_444_984_320


def test_rglru_block_parts_match_reference(hybrid):
    """``causal_conv``, ``apply_rglru`` (with its returned decode state)
    and a chain of ``decode_rglru`` steps, block by block."""
    cfg, _, _, _, params_t = hybrid
    p_t = {k: v[0] for k, v in params_t["layers"]["b0"]["rglru"].items()}
    p_j = {k: jnp.asarray(v.numpy()) for k, v in p_t.items()}
    rng = np.random.RandomState(1)
    B, S, D, W = 2, 9, cfg.d_model, cfg.lru_width
    u = rng.randn(B, S, W).astype(np.float32)
    np.testing.assert_allclose(
        rglru.causal_conv(t(u), p_t["conv_w"], p_t["conv_b"]).numpy(),
        np.asarray(rglru_jax.causal_conv(jnp.asarray(u), p_j["conv_w"],
                                         p_j["conv_b"])), **TOL)
    x = rng.randn(B, S, D).astype(np.float32)
    out_j, st_j = rglru_jax.apply_rglru(cfg, p_j, jnp.asarray(x),
                                        return_state=True)
    out_t, st_t = rglru.apply_rglru(cfg, p_t, t(x), return_state=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    for n in ("h", "conv"):
        np.testing.assert_allclose(st_t[n].numpy(), np.asarray(st_j[n]),
                                   **TOL)
    for step in range(3):
        xs = rng.randn(B, 1, D).astype(np.float32)
        y_j, st_j = rglru_jax.decode_rglru(cfg, p_j, jnp.asarray(xs), st_j)
        y_t = rglru.decode_rglru(cfg, p_t, t(xs), st_t)   # st_t in place
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
        for n in ("h", "conv"):
            np.testing.assert_allclose(st_t[n].numpy(), np.asarray(st_j[n]),
                                       **TOL)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_state_is_left_padded(hybrid, S):
    """A prompt shorter than conv_width - 1 leaves a conv history of
    K - 1 rows, zeros first; decoding from it gives ``apply_rglru``'s
    output for the next position."""
    cfg, _, _, _, params_t = hybrid
    p = {k: v[0] for k, v in params_t["layers"]["b0"]["rglru"].items()}
    x = t(np.random.RandomState(2).randn(1, S + 1, cfg.d_model)
          .astype(np.float32))
    _, st = rglru.apply_rglru(cfg, p, x[:, :S], return_state=True)
    K = cfg.conv_width
    assert st["conv"].shape == (1, K - 1, cfg.lru_width)
    assert torch.equal(st["conv"][:, :K - 1 - S],
                       torch.zeros(1, K - 1 - S, cfg.lru_width))
    y = rglru.decode_rglru(cfg, p, x[:, S:], st)
    full = rglru.apply_rglru(cfg, p, x)
    np.testing.assert_allclose(y.numpy(), full[:, S:].numpy(), **TOL)


def test_forward_logits_match(hybrid):
    cfg, mj, params_j, mt, params_t = hybrid
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 13))
    lj, _ = mj.forward(params_j, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        lt, _ = mt.forward(params_t, {"tokens": t(toks.astype(np.int32))})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_prefill_past_window_then_decode_past_wrap(hybrid):
    """An 11-token prompt over a window of 8 (the prefill rolls the ring),
    then 7 decode steps that wrap it again; logits and every cache leaf
    against the reference after each step, with the step's K/V written
    into the port's cache in place."""
    cfg, mj, params_j, mt, params_t = hybrid
    rng = np.random.RandomState(4)
    B, S, cap = 2, 11, 24
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = mj.prefill(params_j, {"tokens": jnp.asarray(toks)},
                        capacity=cap)
    with torch.no_grad():
        lt, ct = mt.prefill(params_t, {"tokens": t(toks)}, capacity=cap)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert_cache_close(ct, cj)
    ring = ct["layers"]["b2"]["k"]
    assert ring.shape[2] == cfg.attn_window
    cur = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(7):
        lj, cj = mj.decode_step(params_j, cj, jnp.asarray(cur),
                                jnp.asarray(pos))
        with torch.no_grad():
            lt, ct2 = mt.decode_step(params_t, ct, t(cur), t(pos))
        assert ct2 is ct and ct["layers"]["b2"]["k"] is ring  # in place
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert np.array_equal(lt.numpy().argmax(-1),
                              np.asarray(lj).argmax(-1))
        cur = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
    assert_cache_close(ct, cj)


def test_dense_int8_kv_prefill_and_decode_match():
    """qwen3-14b with int8 KV takes the contiguous path: prefill, then
    decode steps over the int8 cache, against the reference (as
    ``tests/test_kernels.py`` holds its Pallas kernel against XLA)."""
    cfg, mj, params_j, mt, params_t = build_pair(
        "qwen3-14b", seed=9, kv_cache_dtype="int8")
    assert mt.prefix_seq_axes() is None
    toks = np.random.RandomState(9).randint(0, cfg.vocab_size, (2, 12))
    toks = toks.astype(np.int32)
    _, cj = mj.prefill(params_j, {"tokens": jnp.asarray(toks[:, :8])},
                       capacity=12)
    with torch.no_grad():
        _, ct = mt.prefill(params_t, {"tokens": t(toks[:, :8])}, capacity=12)
    assert ct["layers"]["b0"]["k"].dtype == torch.int8
    assert_cache_close(ct, cj)
    for i in range(8, 11):
        pos = np.full((2,), i, np.int32)
        lj, cj = mj.decode_step(params_j, cj, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos))
        with torch.no_grad():
            lt, ct = mt.decode_step(params_t, ct, t(toks[:, i:i + 1]),
                                    t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
