"""The port's encoder-decoder (whisper-medium) against the JAX package.

JAX initializes reduced whisper-medium (float32, 2 + 2 layers, 16
encoder frames), the tree goes to the port through ``convert.from_jax``,
and the same numpy frames and tokens run through both.  Logits agree to
rtol = atol = 1e-4 (the tolerance of ``tests/test_torch_models.py``: XLA
and PyTorch sum in different orders).  On the CPU the port's attention
runs its kernels' plain versions; the flash wrapper's non-causal mode is
also held against the Pallas kernel in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.kernels.flash_attention import kernel as fa_jax  # noqa: E402
from repro.models import attention as att_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.models import common as common_jax  # noqa: E402
from repro.models import encdec as encdec_jax  # noqa: E402
from repro.models import mlp as mlp_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_pt  # noqa: E402
from repro_torch.models import attention as att_pt  # noqa: E402
from repro_torch.models import build_model, common, encdec, mlp  # noqa: E402
from repro_torch.models.convert import from_jax, to_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
NAMES = ("whisper-medium", "pixtral-12b")


@pytest.fixture(scope="module")
def whisper():
    cfg_j = get_config_jax("whisper-medium").reduced()
    cfg = get_config("whisper-medium").reduced()
    mj = build_jax(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(11))
    params_np = jax.tree.map(np.asarray, params_j)
    mt = build_model(cfg)
    params_t = from_jax(cfg, params_np, device="cpu")
    rng = np.random.RandomState(5)
    frames = rng.randn(2, cfg.enc_seq, cfg.d_model).astype(np.float32)
    tokens = rng.randint(0, cfg.vocab_size, size=(2, 4)).astype(np.int32)
    return cfg, mj, params_j, params_np, mt, params_t, frames, tokens


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_configs_match_reference(name, reduce):
    a, b = get_config(name), get_config_jax(name)
    if reduce:
        a, b = a.reduced(), b.reduced()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.vocab_padded == b.vocab_padded
    assert str(a.activation_dtype).split(".")[-1] == str(b.activation_dtype)


@pytest.mark.parametrize("name", NAMES)
def test_schema_and_params_match_reference(name):
    """Every leaf's shape equals the reference's abstract parameters, at
    full width (nothing is allocated) and reduced."""
    for cfg, cfg_j in ((get_config(name), get_config_jax(name)),
                       (get_config(name).reduced(),
                        get_config_jax(name).reduced())):
        mt, mj = build_model(cfg), build_jax(cfg_j)
        shapes = jax.tree.map(lambda s: tuple(s.shape),
                              mj.abstract_params())
        assert jax.tree.map(lambda s: tuple(s.shape), mt.schema(),
                            is_leaf=lambda s: isinstance(
                                s, common.PSpec)) == shapes
        assert mt.num_params() == mj.num_params()


def test_full_width_parameter_counts():
    """The counts the chip phases print (the reference's ``num_params``)."""
    assert build_model(get_config("whisper-medium")).num_params() \
        == 758_353_920
    assert build_model(get_config("pixtral-12b")).num_params() \
        == 12_772_070_400


@pytest.mark.parametrize("d", [64, 1024])
@pytest.mark.parametrize("dtype", [(jnp.float32, torch.float32),
                                   (jnp.bfloat16, torch.bfloat16)])
def test_sinusoidal_positions_match(d, dtype):
    pos = np.array([[0, 3, 17], [1499, 448, 5]], np.int32)
    want = common_jax.sinusoidal_positions(jnp.asarray(pos), d, dtype[0])
    got = common.sinusoidal_positions(t(pos), d, dtype[1])
    assert got.dtype == dtype[1] and tuple(got.shape) == (2, 3, d)
    # a last-bit difference between XLA's and PyTorch's float32 exp in a
    # frequency becomes position x 6e-8 in the angle: ~1e-4 at 1499
    tol = 2e-4 if dtype[1] == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_gelu_mlp_matches(whisper):
    cfg, _, _, params_np, _, params_t, _, _ = whisper
    p_np = jax.tree.map(lambda a: a[1], params_np["dec_layers"]["mlp"])
    p_np = {**p_np, "b_up": np.random.RandomState(1).randn(
        *p_np["b_up"].shape).astype(np.float32)}   # biases init to zeros
    x = np.random.RandomState(2).randn(2, 5, cfg.d_model).astype(np.float32)
    assert set(mlp.mlp_schema(cfg, gated=False)) == set(p_np)
    want = mlp_jax.apply_mlp(cfg, jax.tree.map(jnp.asarray, p_np),
                             jnp.asarray(x), gated=False)
    got = mlp.apply_mlp(cfg, {k: t(v) for k, v in p_np.items()}, t(x),
                        gated=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_attention_cache_matches(whisper):
    cfg, _, _, params_np, _, _, frames, _ = whisper
    p_np = jax.tree.map(lambda a: a[0], params_np["dec_layers"]["cross_attn"])
    assert set(p_np) == {"wq", "wk", "wv", "wo"}
    assert set(att_pt.attn_schema(cfg.replace(qkv_bias=True, qk_norm=True),
                                  cross=True)) == set(p_np)
    want = att_jax.cross_attention_cache(
        cfg, jax.tree.map(jnp.asarray, p_np), jnp.asarray(frames))
    got = att_pt.cross_attention_cache(
        cfg, {k: t(v) for k, v in p_np.items()}, t(frames))
    for n in ("k", "v"):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,H,KVH", [
    (48, 48, 4, 4),      # the encoder's self-attention: S = T
    (4, 40, 4, 4),       # the prefill's cross-attention: S < one tile
    (20, 72, 8, 2),      # S != T under GQA
])
def test_flash_non_causal_matches_pallas(S, T, H, KVH, dtype):
    rng = np.random.RandomState(S + T)
    d = 32
    q = rng.randn(2, S, H, d).astype(np.float32)
    k = rng.randn(2, T, KVH, d).astype(np.float32)
    v = rng.randn(2, T, KVH, d).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = fa_jax.flash_attention_fwd(
        *(jnp.asarray(x, jd) for x in (q, k, v)), causal=False,
        block_q=16, block_kv=16, interpret=True)
    got = fa_pt.flash_attention(*(t(x).to(td) for x in (q, k, v)),
                                causal=False)
    assert got.dtype == td and tuple(got.shape) == q.shape
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_cross_attention_is_non_causal_only(whisper):
    cfg, _, _, _, _, params_t, frames, _ = whisper
    p = {k: v[0] for k, v in params_t["dec_layers"]["cross_attn"].items()}
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.raises(ValueError, match="non-causal"):
        att_pt.full_attention(cfg, p, x, positions=torch.zeros(1, 3),
                              kv_x=t(frames[:1]))


def test_cross_attention_from_projected_kv_matches(whisper):
    """The decoder's cross-attention over K/V projected once (``kv=``,
    what the prefill also keeps as its cache) gives the ``kv_x`` path's
    output bit for bit, and the reference's within the tolerance."""
    cfg, _, _, params_np, _, params_t, frames, _ = whisper
    p_np = jax.tree.map(lambda a: a[0], params_np["dec_layers"]["cross_attn"])
    p = {k: v[0] for k, v in params_t["dec_layers"]["cross_attn"].items()}
    x = np.random.RandomState(3).randn(frames.shape[0], 3,
                                       cfg.d_model).astype(np.float32)
    pos = torch.arange(3, dtype=torch.int32)[None].repeat(frames.shape[0], 1)
    cross = att_pt.cross_attention_cache(cfg, p, t(frames))
    got = att_pt.full_attention(cfg, p, t(x), positions=pos,
                                kv=(cross["k"], cross["v"]), causal=False)
    assert torch.equal(got, att_pt.full_attention(
        cfg, p, t(x), positions=pos, kv_x=t(frames), causal=False))
    want = att_jax.full_attention(
        cfg, jax.tree.map(jnp.asarray, p_np), jnp.asarray(x),
        positions=jnp.asarray(pos.numpy()), kv_x=jnp.asarray(frames),
        causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not both"):
        att_pt.full_attention(cfg, p, t(x), positions=pos, kv_x=t(frames),
                              kv=(cross["k"], cross["v"]), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        att_pt.full_attention(cfg, p, t(x), positions=pos,
                              kv=(cross["k"], cross["v"]))


def test_encode_matches(whisper):
    cfg, _, params_j, _, _, params_t, frames, _ = whisper
    want = encdec_jax.encode(cfg, params_j, jnp.asarray(frames))
    got = encdec.encode(cfg, params_t, t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_matches(whisper):
    cfg, mj, params_j, _, mt, params_t, frames, tokens = whisper
    lj, aux_j = mj.forward(params_j, {"tokens": jnp.asarray(tokens),
                                      "encoder_frames": jnp.asarray(frames)})
    lt, aux_t = mt.forward(params_t, {"tokens": t(tokens),
                                      "encoder_frames": t(frames)})
    assert tuple(lt.shape) == (2, 4, cfg.vocab_padded)
    v = cfg.vocab_size
    np.testing.assert_allclose(lt[..., :v].numpy(), np.asarray(lj)[..., :v],
                               **TOL)
    assert float(aux_t) == float(aux_j) == 0.0


def test_prefill_and_decode_steps_match(whisper):
    """Prefill at capacity 16, then eight greedy decode steps: the logits
    of each at 1e-4, the greedy tokens equal, the caches close."""
    cfg, mj, params_j, _, mt, params_t, frames, tokens = whisper
    cap, v = 16, cfg.vocab_size
    batch_j = {"tokens": jnp.asarray(tokens),
               "encoder_frames": jnp.asarray(frames)}
    lj, cache_j = mj.prefill(params_j, batch_j, cap)
    with torch.no_grad():
        lt, cache_t = mt.prefill(params_t, {"tokens": t(tokens),
                                            "encoder_frames": t(frames)},
                                 cap)
    assert set(cache_t["dec"]) == {"k", "v", "cross_k", "cross_v"}
    for n, leaf in cache_t["dec"].items():
        assert tuple(leaf.shape) == cache_j["dec"][n].shape
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(cache_j["dec"][n]), **TOL)
    pos = np.full((2,), tokens.shape[1], np.int32)
    for step in range(8):
        np.testing.assert_allclose(lt[:, :v].numpy(), np.asarray(lj)[:, :v],
                                   **TOL, err_msg=f"step {step}")
        tok_j = np.asarray(lj)[:, :v].argmax(-1).astype(np.int32)
        tok_t = lt[:, :v].argmax(-1).numpy().astype(np.int32)
        assert np.array_equal(tok_j, tok_t), step
        lj, cache_j = mj.decode_step(params_j, cache_j,
                                     jnp.asarray(tok_j[:, None]),
                                     jnp.asarray(pos))
        with torch.no_grad():
            lt, same = mt.decode_step(params_t, cache_t, t(tok_t[:, None]),
                                      t(pos))
        assert same is cache_t       # updated in place
        pos = pos + 1
    for n in ("k", "v"):
        np.testing.assert_allclose(cache_t["dec"][n].numpy(),
                                   np.asarray(cache_j["dec"][n]), **TOL)


def test_init_cache_shapes(whisper):
    cfg, mj, _, _, mt, _, _, _ = whisper
    got = mt.init_cache(3, 10, device="cpu")
    want = mj.init_cache(3, 10)
    assert {n: tuple(x.shape) for n, x in got["dec"].items()} \
        == {n: x.shape for n, x in want["dec"].items()}
    assert all(not x.any() for x in got["dec"].values())


def test_prefix_prefill_and_paged_refused(whisper):
    """As in the reference: no prefix-aware prefill, no sliceable cache,
    so no paged layout."""
    cfg, _, _, _, mt, params_t, frames, tokens = whisper
    batch = {"tokens": t(tokens), "encoder_frames": t(frames)}
    assert mt.prefix_seq_axes() is None
    with pytest.raises(ValueError, match="not supported for enc_dec"):
        mt.prefill(params_t, batch, 16, prefix={}, prefix_len=2)
    with pytest.raises(ValueError, match="not supported for enc_dec"):
        mt.prefill(params_t, batch, 16, last_index=1)
    with pytest.raises(ValueError, match="paged layout unsupported"):
        mt.init_paged_cache(4, 16, device="cpu")


def test_engine_refuses_encdec(whisper):
    """The reference engine admits ``{"tokens": prompt}`` only, which an
    encoder-decoder cannot prefill: the port refuses at construction."""
    _, _, _, _, mt, params_t, _, _ = whisper
    with pytest.raises(NotImplementedError, match="encoder frames"):
        ServingEngine(mt, params_t, max_slots=2, max_len=32, device="cpu")


def test_engine_refusal_matches_reference_failure(whisper):
    """The reference engine's prefill of a token-only request fails where
    the encoder reads its frames, which is why the port refuses."""
    cfg, mj, params_j, _, _, _, _, tokens = whisper
    with pytest.raises(KeyError, match="encoder_frames"):
        mj.prefill(params_j, {"tokens": jnp.asarray(tokens)}, 16)


def test_round_trip_bit_for_bit(whisper):
    cfg, _, _, params_np, _, params_t, _, _ = whisper
    back = to_numpy(params_t)
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert b.dtype == a.dtype and np.array_equal(a, b), path
    bf = from_jax(cfg, params_np, device="cpu", dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16
               for x in jax.tree.leaves(bf))


def test_from_jax_refuses_unstacked_layers(whisper):
    cfg, _, _, params_np, _, _, _, _ = whisper
    unstacked = {**params_np, "dec_layers": {
        "g0": jax.tree.map(lambda a: a[0], params_np["dec_layers"])}}
    with pytest.raises(ValueError, match="scan_layers"):
        from_jax(cfg, unstacked, device="cpu")


def test_port_init_runs_the_model(whisper):
    """The port's own seeded init, through every entry point, on the CPU:
    finite logits of the right shapes."""
    cfg, _, _, _, mt, _, frames, tokens = whisper
    params = mt.init(0, device="cpu")
    batch = {"tokens": t(tokens), "encoder_frames": t(frames)}
    with torch.no_grad():
        logits, _ = mt.forward(params, batch)
        last, cache = mt.prefill(params, batch, 8)
        step, _ = mt.decode_step(params, cache, t(tokens[:, :1]),
                                 torch.full((2,), 4, dtype=torch.int32))
    assert torch.allclose(logits[:, -1], last, rtol=1e-4, atol=1e-4)
    assert tuple(step.shape) == (2, cfg.vocab_padded)
    assert torch.isfinite(step[:, :cfg.vocab_size]).all()
