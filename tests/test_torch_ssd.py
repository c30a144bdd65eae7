"""The port's Mamba-2/SSD family against the JAX package.

Kernel: on the CPU the port's ``ssd_chunked`` wrapper takes its plain
version (the CUDA kernel runs only on the card, where ``chip_smoke.py``
holds it against that plain version); here the same numpy inputs go
through the JAX Pallas kernel in interpret mode and the JAX oracle at
rtol = atol = 2e-4, the tolerance of ``tests/test_kernels.py``'s SSD cases
(sums of many f32 products in another order).

Model: ``mamba2-2.7b.reduced()`` (2 SSD blocks, d_inner 128, 8 heads of
16, state 16, chunk 8) on the port's seeded parameters handed to JAX
(``helpers_torch.build_pair``), JAX at its default ``attention_impl=
"xla"``.  Block parts and cache leaves agree to 1e-5, logits to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import assert_cache_close, build_pair  # noqa: E402
from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.kernels.ssd import ops as ssd_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.models import ssd as ssd_model_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_pt  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssd  # noqa: E402
from repro_torch.models.convert import from_jax, to_numpy  # noqa: E402

KTOL = dict(rtol=2e-4, atol=2e-4)
PTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.tensor(np.asarray(x))


def _inputs(seed, B, S, H, P, N, a_scale=0.5, a_shift=0.0, h0=False):
    rng = np.random.RandomState(seed)
    xh = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    a_log = (rng.randn(H) * a_scale + a_shift).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    state = rng.randn(B, H, P, N).astype(np.float32) if h0 else None
    return xh, dt, a_log, Bm, Cm, state


def _both(x):
    return (None, None) if x is None else (jnp.asarray(x), t(x))


def _run_both(inputs, chunk, jax_fn):
    jx = [_both(v)[0] for v in inputs]
    tx = [_both(v)[1] for v in inputs]
    yj, hj = jax_fn(*jx[:5], chunk=chunk, initial_state=jx[5])
    yt, ht = ssd_pt.ssd_chunked(*tx[:5], chunk=chunk, initial_state=tx[5])
    assert yt.dtype == ht.dtype == torch.float32
    assert yt.shape == yj.shape and ht.shape == hj.shape
    return (yj, hj), (yt, ht)


# ---------------------------------------------------------------------------
# the chunk scan


@pytest.mark.parametrize("B,S,H,P,N,chunk,h0", [
    (1, 128, 2, 16, 16, 32, False),
    (2, 64, 4, 32, 8, 16, False),
    (1, 256, 1, 64, 32, 64, False),
    (1, 64, 2, 16, 8, 16, True),
], ids=["s128", "s64b2", "s256", "initial_state"])
def test_ssd_matches_jax_kernel(B, S, H, P, N, chunk, h0):
    """The shapes of ``tests/test_kernels.py`` and its initial-state case,
    against the Pallas kernel in interpret mode."""
    inputs = _inputs(4, B, S, H, P, N, h0=h0)
    (yj, hj), (yt, ht) = _run_both(
        inputs, chunk, lambda *a, **k: ssd_jax.ssd_chunked(
            *a, **k, interpret=True))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **KTOL)


@pytest.mark.parametrize("S", [13, 37])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_ragged_tail_matches_reference(S, h0):
    """A length that is not a chunk multiple: the tail is padded with
    dt = 0, so the final state is that of the real steps."""
    inputs = _inputs(5, 2, S, 3, 16, 8, h0=h0)
    (yj, hj), (yt, ht) = _run_both(inputs, 8,
                                   ssd_model_jax.ssd_chunked_ref)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **KTOL)


def test_ssd_strong_decay_stays_finite():
    """A decay whose in-chunk cumulative log falls far below -100:
    exp(cum) underflows, and the decay matrix is the exponential of
    segment sums, never a ratio of exponentials, so nothing becomes
    0/0."""
    inputs = _inputs(6, 1, 96, 2, 16, 8, a_scale=0.0, a_shift=2.5)
    xh, dt, a_log = inputs[:3]
    cum = np.cumsum(dt[0, :32] * -np.exp(a_log), axis=0)
    assert cum.min() < -100
    (yj, hj), (yt, ht) = _run_both(inputs, 32,
                                   ssd_model_jax.ssd_chunked_ref)
    assert torch.isfinite(yt).all() and torch.isfinite(ht).all()
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **KTOL)


def test_ssd_plain_version_holds_float64_recurrence():
    """At the serving model's decay (a_log = 1, dt = softplus(N(0, 1))) the
    in-chunk cumulative log decay reaches about -560 over a 256-step
    chunk, where ``cum_i - cum_j`` keeps only ~6e-5 in float32; the plain
    version sums each segment on its own and stays within 2e-4 of the
    step-by-step recurrence h_t = exp(dt·A)·h + dt·x⊗B, y_t = h·C in
    float64."""
    xh, dt, a_log, Bm, Cm, _ = _inputs(8, 1, 512, 2, 16, 128, a_scale=0.0,
                                       a_shift=1.0)
    da = dt[0].astype(np.float64) * -np.exp(a_log.astype(np.float64))
    assert np.cumsum(da[:256], axis=0).min() < -400
    h = np.zeros((2, 16, 128))
    y64 = np.zeros((512, 2, 16))
    for s in range(512):
        h = np.exp(da[s])[:, None, None] * h + \
            (xh[0, s] * dt[0, s][:, None])[:, :, None] * Bm[0, s]
        y64[s] = h @ Cm[0, s]
    y, state = ssd_pt.ssd_chunked(*(t(v) for v in (xh, dt, a_log, Bm, Cm)),
                                  chunk=256)
    np.testing.assert_allclose(y[0].numpy(), y64, **KTOL)
    np.testing.assert_allclose(state[0].numpy(), h, **KTOL)


def test_ssd_wrapper_validates_and_counts_no_cpu_launch():
    """Bad dtypes, shapes and devices raise; the plain CPU path leaves the
    launch counter alone."""
    xh, dt, a_log, Bm, Cm, _ = (t(v) if v is not None else None
                                for v in _inputs(7, 1, 16, 2, 16, 8))
    before = ssd_pt.ssd_chunked.launches
    ssd_pt.ssd_chunked(xh, dt, a_log, Bm, Cm, chunk=8)
    assert ssd_pt.ssd_chunked.launches == before
    with pytest.raises(TypeError, match="floating"):
        ssd_pt.ssd_chunked(xh.to(torch.int32), dt, a_log, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="dt"):
        ssd_pt.ssd_chunked(xh, dt[:, :-1], a_log, Bm, Cm, chunk=8)
    with pytest.raises(ValueError, match="C"):
        ssd_pt.ssd_chunked(xh, dt, a_log, Bm, Cm[..., :4], chunk=8)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_pt.ssd_chunked(xh, dt, a_log, Bm, Cm, chunk=8,
                           initial_state=torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="meta"):
        ssd_pt.ssd_chunked(xh, dt, a_log, Bm.to("meta"), Cm, chunk=8)
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_pt.ssd_chunked(*(v.to("meta") for v in (xh, dt, a_log, Bm, Cm)),
                           chunk=8)
    assert ssd_pt.ssd_chunked.launches == before


# ---------------------------------------------------------------------------
# the model


@pytest.fixture(scope="module")
def mamba():
    return build_pair("mamba2-2.7b")


def _block_params(params_t):
    p_t = {k: v[0] for k, v in params_t["layers"]["b0"]["ssd"].items()}
    return p_t, {k: jnp.asarray(v.numpy()) for k, v in p_t.items()}


def test_layer_grouping_and_params_are_the_reference(mamba):
    """Full width, without allocating: the same block kinds and grouping,
    the reference's parameter shapes (from ``jax.eval_shape``) and count,
    and a model that is served from the contiguous cache."""
    from repro.models import lm as lm_jax
    cfg, mj, _, mt, _ = mamba
    assert lm.block_kinds(cfg) == lm_jax.block_kinds(mj.cfg) == ["ssd"] * 2
    assert mt.prefix_seq_axes() is None
    full, full_j = get_config("mamba2-2.7b"), get_config_jax("mamba2-2.7b")
    assert (full.d_inner, full.ssm_heads) == (5120, 80)
    assert lm._layer_groups(full) == (["ssd"], 64, [])
    model, model_j = build_model(full), build_jax(full_j)
    abstract = jax.tree.map(lambda s: tuple(s.shape),
                            model_j.abstract_params())

    def spec_shapes(tree):
        return {k: spec_shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert spec_shapes(model.schema()) == abstract
    assert abstract["layers"]["b0"]["ssd"]["w_in"] == (64, 2560, 10576)
    assert abstract["lm_head"] == (2560, 50432)
    assert model.num_params() == model_j.num_params() == 2_832_074_240


def test_round_trip_bit_for_bit():
    """``from_jax`` → ``to_numpy`` on the SSD tree (the reference's own
    init), leaf for leaf and bit for bit, in float32 and bfloat16."""
    cfg = get_config("mamba2-2.7b").reduced()
    mj = build_jax(get_config_jax("mamba2-2.7b").reduced())
    params_np = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(5)))
    assert set(params_np["layers"]["b0"]) == {"ln1", "ssd"}
    for dtype in (np.float32, jnp.bfloat16):
        tree = jax.tree.map(lambda a: np.asarray(a, dtype), params_np)
        back = to_numpy(from_jax(cfg, tree, device="cpu"))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            assert np.array_equal(flat_b[path],
                                  np.asarray(leaf, np.float32)), path


def test_ssd_block_parts_match_reference(mamba):
    """``apply_ssd`` with its returned decode state, then a chain of
    ``decode_ssd`` steps updating the cache in place, block by block."""
    cfg, _, _, _, params_t = mamba
    p_t, p_j = _block_params(params_t)
    rng = np.random.RandomState(1)
    B, S = 2, 11
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    out_j, st_j = ssd_model_jax.apply_ssd(cfg, p_j, jnp.asarray(x),
                                          return_state=True)
    out_t, st_t = ssd.apply_ssd(cfg, p_t, t(x), return_state=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **PTOL)
    for n in ("ssm", "conv"):
        assert tuple(st_t[n].shape) == st_j[n].shape
        np.testing.assert_allclose(st_t[n].numpy(), np.asarray(st_j[n]),
                                   **PTOL)
    ssm_buf = st_t["ssm"]
    for _ in range(3):
        xs = rng.randn(B, 1, cfg.d_model).astype(np.float32)
        y_j, st_j = ssd_model_jax.decode_ssd(cfg, p_j, jnp.asarray(xs), st_j)
        y_t = ssd.decode_ssd(cfg, p_t, t(xs), st_t)
        assert st_t["ssm"] is ssm_buf                      # in place
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **PTOL)
        for n in ("ssm", "conv"):
            np.testing.assert_allclose(st_t[n].numpy(), np.asarray(st_j[n]),
                                       **PTOL)
    cache = ssd.init_ssd_cache(cfg, B, torch.float32, "cpu")
    ref = ssd_model_jax.init_ssd_cache(cfg, B, jnp.float32)
    assert {n: tuple(v.shape) for n, v in cache.items()} \
        == {n: v.shape for n, v in ref.items()}


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_state_is_left_padded(mamba, S):
    """A prompt shorter than conv_width - 1 leaves a conv history of
    K - 1 rows, zeros first; decoding from it gives ``apply_ssd``'s output
    for the next position."""
    cfg, _, _, _, params_t = mamba
    p, _ = _block_params(params_t)
    x = t(np.random.RandomState(2).randn(1, S + 1, cfg.d_model)
          .astype(np.float32))
    _, st = ssd.apply_ssd(cfg, p, x[:, :S], return_state=True)
    K, width = cfg.conv_width, cfg.d_inner + 2 * cfg.ssm_state
    assert st["conv"].shape == (1, K - 1, width)
    assert torch.equal(st["conv"][:, :K - 1 - S],
                       torch.zeros(1, K - 1 - S, width))
    y = ssd.decode_ssd(cfg, p, x[:, S:], st)
    full = ssd.apply_ssd(cfg, p, x)
    np.testing.assert_allclose(y.numpy(), full[:, S:].numpy(), **PTOL)


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_decode_equals_forward(mamba, S):
    """The whole model: prefill of a 1- or 2-token prompt, then decode
    steps, give the logits of the full ``forward`` at each position."""
    cfg, _, _, mt, params_t = mamba
    toks = t(np.random.RandomState(3).randint(0, cfg.vocab_size, (1, S + 3))
             .astype(np.int32))
    with torch.no_grad():
        full, _ = mt.forward(params_t, {"tokens": toks})
        lg, cache = mt.prefill(params_t, {"tokens": toks[:, :S]}, capacity=8)
        np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(), **TOL)
        for i in range(S, S + 3):
            lg, cache = mt.decode_step(params_t, cache, toks[:, i:i + 1],
                                       torch.tensor([i], dtype=torch.int32))
            np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), **TOL)


def test_forward_logits_match(mamba):
    cfg, mj, params_j, mt, params_t = mamba
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 13))
    lj, _ = mj.forward(params_j, {"tokens": jnp.asarray(toks, jnp.int32)})
    with torch.no_grad():
        lt, _ = mt.forward(params_t, {"tokens": t(toks.astype(np.int32))})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("S", [13, 32])
def test_prefill_then_decode_match(mamba, S):
    """A ragged (13) and a chunk-multiple (32) prompt: prefill, then 4
    decode steps; logits and every cache leaf against the reference after
    each step, the port's cache updated in place."""
    cfg, mj, params_j, mt, params_t = mamba
    rng = np.random.RandomState(4)
    B = 2
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj = mj.prefill(params_j, {"tokens": jnp.asarray(toks)},
                        capacity=S + 8)
    with torch.no_grad():
        lt, ct = mt.prefill(params_t, {"tokens": t(toks)}, capacity=S + 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert_cache_close(ct, cj)
    state = ct["layers"]["b0"]["ssm"]
    cur = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    for _ in range(4):
        lj, cj = mj.decode_step(params_j, cj, jnp.asarray(cur),
                                jnp.asarray(pos))
        with torch.no_grad():
            lt, ct2 = mt.decode_step(params_t, ct, t(cur), t(pos))
        assert ct2 is ct and ct["layers"]["b0"]["ssm"] is state
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        assert_cache_close(ct, cj)
        cur = np.asarray(lj).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1
