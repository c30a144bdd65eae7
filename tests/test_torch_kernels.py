"""The port's kernels' plain versions against the JAX package.

On the CPU the port's kernel wrappers take their plain PyTorch versions
(the CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each kernel against its plain version).  Here the
same numpy inputs go through the JAX Pallas kernels in interpret mode,
the JAX oracles and the port, at the tolerances of
``tests/test_kernels.py``: 2e-5 for float32, 2e-2 for bfloat16.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from repro.kernels.decode_attention import kernel as da_jax  # noqa: E402
from repro.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref as decode_ref_jax)
from repro.kernels.flash_attention import ops as fa_jax  # noqa: E402
from repro.kernels.paged_attention import ops as pa_jax  # noqa: E402
from repro.kernels.paged_attention.ref import (  # noqa: E402
    paged_decode_attention_ref as paged_ref_jax)
from repro.kernels.rglru import kernel as lru_jax  # noqa: E402
from repro.kernels.rglru.ref import rglru_scan_ref as lru_ref_jax  # noqa: E402
from repro.models import attention as att_jax  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_pt  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_pt  # noqa: E402
from repro_torch.kernels.flash_attention.ref import keep_mask  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_pt  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_pt  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_pt  # noqa: E402
from repro_torch.models import attention as att_pt  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(x, name):
    """The same numpy array in each framework, cast to ``name``."""
    jd, td = DTYPES[name]
    return jnp.asarray(x, jnp.float32).astype(jd), \
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(td)


def close(a_jax, b_torch, name):
    np.testing.assert_allclose(np.asarray(a_jax, np.float32),
                               b_torch.float().numpy(), **tol(name))


# ---------------------------------------------------------------------------
# paged decode attention


def _paged_case(B, ps, N, H, KVH, d, seed=4):
    """Page 0 scratch, shuffled per-sequence tables (a kernel that ignored
    the table would read the wrong pages)."""
    rng = np.random.RandomState(seed)
    P = B * N + 3
    q = rng.randn(B, 1, H, d)
    kp = rng.randn(P, ps, KVH, d)
    vp = rng.randn(P, ps, KVH, d)
    table = (rng.permutation(P - 1)[: B * N] + 1).reshape(B, N)
    return q, kp, vp, table.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,ps,N,H,KVH,d,lengths,window", [
    (2, 16, 4, 4, 4, 32, (64, 37), 0),   # full + ragged last page
    (2, 8, 6, 8, 2, 64, (48, 41), 0),    # GQA 4:1, small pages
    (1, 32, 3, 4, 1, 32, (70,), 0),      # MQA, big pages, ragged
    (2, 16, 4, 4, 4, 32, (64, 50), 24),  # sliding window across pages
    (1, 16, 2, 2, 2, 16, (1,), 0),       # single valid token
    (2, 16, 3, 5, 1, 80, (33, 40), 0),   # stablelm head_dim, G=5
])
def test_paged_decode_matches_jax(B, ps, N, H, KVH, d, lengths, window,
                                  dtype):
    q, kp, vp, table = _paged_case(B, ps, N, H, KVH, d)
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, kp, vp))
    lens = np.asarray(lengths, np.int32)
    out_pt = pa_pt.paged_decode_attention(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens),
        window=window)
    out_pl = pa_jax.paged_decode_attention(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(lens), window=window,
        interpret=True)
    ref = paged_ref_jax(qj, kj, vj, jnp.asarray(table), jnp.asarray(lens),
                        window=window)
    assert out_pt.dtype == qt.dtype and out_pt.shape == qt.shape
    close(out_pl, out_pt, dtype)
    close(ref, out_pt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_retired_rows_on_scratch_page(dtype):
    """Retired slots: every table entry is scratch page 0 and the length
    is stale.  The output must stay finite and equal the reference's; the
    live rows are unaffected."""
    B, ps, N, H, KVH, d = 3, 8, 4, 4, 2, 32
    q, kp, vp, table = _paged_case(B, ps, N, H, KVH, d, seed=9)
    table[1] = 0
    table[2] = 0
    lens = np.asarray([29, 17, N * ps], np.int32)
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, kp, vp))
    out_pt = pa_pt.paged_decode_attention(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens))
    assert torch.isfinite(out_pt.float()).all()
    ref = paged_ref_jax(qj, kj, vj, jnp.asarray(table), jnp.asarray(lens))
    close(ref, out_pt, dtype)
    out_pl = pa_jax.paged_decode_attention(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(lens), interpret=True)
    close(out_pl, out_pt, dtype)


def test_paged_decode_stale_pages_cannot_poison():
    """Positions past a sequence's length may hold anything, NaN
    included: the output must not see them."""
    B, ps, N, H, KVH, d = 2, 8, 3, 4, 4, 16
    q, kp, vp, table = _paged_case(B, ps, N, H, KVH, d, seed=5)
    lens = np.asarray([11, 20], np.int32)
    clean = pa_pt.paged_decode_attention(
        *(torch.from_numpy(x).float() for x in (q, kp, vp)),
        torch.from_numpy(table), torch.from_numpy(lens))
    for b, n in enumerate(lens):
        for j in range(n, N * ps):
            page, off = table[b, j // ps], j % ps
            kp[page, off] = np.nan
            vp[page, off] = np.nan
    dirty = pa_pt.paged_decode_attention(
        *(torch.from_numpy(x).float() for x in (q, kp, vp)),
        torch.from_numpy(table), torch.from_numpy(lens))
    assert torch.equal(clean, dirty)


# ---------------------------------------------------------------------------
# flash attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KVH,d,window", [
    (1, 128, 4, 4, 32, 0),
    (2, 256, 4, 2, 64, 0),      # GQA
    (1, 256, 8, 1, 32, 0),      # MQA
    (2, 128, 4, 4, 32, 64),     # sliding window
    (1, 192, 2, 2, 16, 0),      # non-multiple of block
    (1, 96, 4, 4, 80, 0),       # stablelm head_dim
])
def test_flash_matches_jax_kernel(B, S, H, KVH, d, window, dtype):
    rng = np.random.RandomState(0)
    q = rng.randn(B, S, H, d)
    k = rng.randn(B, S, KVH, d)
    v = rng.randn(B, S, KVH, d)
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, k, v))
    out_pt = fa_pt.flash_attention(qt, kt, vt, causal=True, window=window)
    out_pl = fa_jax.flash_attention(qj, kj, vj, True, window, True)
    close(out_pl, out_pt, dtype)


@pytest.mark.parametrize("prefix_len", [0, 21, 32])
def test_flash_prefix_mode_matches_mha_reference(prefix_len):
    """Prefix mode against the reference engine's prefill attention:
    ``mha_reference`` over [padded prefix ; suffix] with
    ``prefix_causal_mask``, for an empty, a ragged and a full prefix."""
    B, S, Tpad, H, KVH, d = 2, 24, 32, 4, 2, 16
    rng = np.random.RandomState(prefix_len)
    q = rng.randn(B, S, H, d).astype(np.float32)
    k = rng.randn(B, Tpad + S, KVH, d).astype(np.float32)
    v = rng.randn(B, Tpad + S, KVH, d).astype(np.float32)
    mask = att_jax.prefix_causal_mask(S, Tpad, prefix_len)
    ref = att_jax.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), mask=mask)
    out = fa_pt.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, prefix_pad=Tpad, prefix_len=prefix_len)
    close(ref, out, "float32")
    # the port's own mask and plain attention are the reference's too
    mask_pt = att_pt.prefix_causal_mask(S, Tpad, prefix_len)
    assert np.array_equal(np.asarray(mask), mask_pt.numpy())
    plain = att_pt.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), mask=mask_pt)
    close(ref, plain, "float32")


@pytest.mark.parametrize("window", [0, 5])
def test_flash_mask_without_prefix_is_reference_causal_mask(window):
    """With no prefix the flash mask is the reference's ``causal_mask``
    (and the port's copy of it)."""
    S = 12
    ref = np.asarray(att_jax.causal_mask(S, S, window=window))[0, 0]
    assert np.array_equal(
        att_pt.causal_mask(S, S, window=window)[0, 0].numpy(), ref)
    assert np.array_equal(keep_mask(S, S, window=window).numpy(), ref)


def test_flash_prefix_args_validated():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 12, 2, 8)
    with pytest.raises(ValueError, match="prefix_len"):
        fa_pt.flash_attention(q, k, k, prefix_pad=8, prefix_len=9)
    with pytest.raises(ValueError, match="prefix_len"):
        fa_pt.flash_attention(q, k, k, prefix_pad=16, prefix_len=0)


# ---------------------------------------------------------------------------
# contiguous decode attention (dense and int8)


def _decode_case(B, C, H, KVH, d, seed=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, d), rng.randn(B, C, KVH, d),
            rng.randn(B, C, KVH, d))


def _ring_valid(positions, C):
    """The reference's ring mask: ``(j <= pos) | (pos >= C)``."""
    pos = np.asarray(positions)[:, None]
    j = np.arange(C)[None, :]
    return (j <= pos) | (pos >= C)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,KVH,d,fill", [
    (2, 256, 4, 4, 32, 200),
    (2, 512, 8, 2, 64, 512),
    (1, 384, 4, 1, 32, 100),    # MQA, partially filled, ragged C
    (2, 256, 16, 1, 256, 77),   # recurrentgemma's MQA, d = 256
])
def test_decode_attention_matches_jax(B, C, H, KVH, d, fill, dtype):
    q, k, v = _decode_case(B, C, H, KVH, d)
    valid = np.arange(C)[None, :] < np.asarray([[fill]] * B)
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, k, v))
    out = da_pt.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    close(da_jax.decode_attention_fwd(qj, kj, vj, jnp.asarray(valid),
                                      interpret=True), out, dtype)
    close(decode_ref_jax(qj, kj, vj, jnp.asarray(valid)), out, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ring_mask(dtype):
    """A ring buffer of C slots: rows that wrapped (pos >= C) attend every
    slot, the others slots [0, pos]; the port's mask is the reference's."""
    from repro_torch.models.attention import decode_valid
    B, C, H, KVH, d = 4, 64, 8, 2, 32
    positions = np.asarray([63, 64, 150, 5], np.int32)
    valid = _ring_valid(positions, C)
    assert np.array_equal(
        decode_valid(torch.from_numpy(positions), C, window=C).numpy(), valid)
    assert np.array_equal(
        decode_valid(torch.from_numpy(positions), C, window=0).numpy(),
        np.arange(C)[None, :] <= positions[:, None])
    q, k, v = _decode_case(B, C, H, KVH, d, seed=3)
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, k, v))
    out = da_pt.decode_attention(qt, kt, vt, torch.from_numpy(valid))
    close(da_jax.decode_attention_fwd(qj, kj, vj, jnp.asarray(valid),
                                      block_kv=16, interpret=True), out,
          dtype)


def test_decode_attention_nan_in_invalid_rows():
    """Unwritten or stale slots may hold NaN: the output equals the
    clean one, as the JAX kernel's (which zeroes invalid V rows)."""
    B, C, H, KVH, d = 2, 128, 4, 2, 32
    q, k, v = _decode_case(B, C, H, KVH, d, seed=5)
    valid = _ring_valid([40, 90], C)
    clean = da_pt.decode_attention(*(torch.from_numpy(x).float()
                                     for x in (q, k, v)),
                                   torch.from_numpy(valid))
    k[~valid] = np.nan
    v[~valid] = np.nan
    dirty = da_pt.decode_attention(*(torch.from_numpy(x).float()
                                     for x in (q, k, v)),
                                   torch.from_numpy(valid))
    assert torch.equal(clean, dirty)
    ref = da_jax.decode_attention_fwd(
        *(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
        jnp.asarray(valid), interpret=True)
    close(ref, dirty, "float32")


def test_quantize_kv_bit_exact():
    """int8 K/V and their scales are the reference's bit for bit, ties
    (x / scale at .5) rounding half to even included."""
    from repro_torch.models.attention import dequantize_kv, quantize_kv
    rng = np.random.RandomState(6)
    x = rng.randn(3, 7, 2, 16).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]      # scale 1: exact ties
    qj, sj = att_jax.quantize_kv(jnp.asarray(x))
    qt, st = quantize_kv(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert qt[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    assert np.array_equal(
        dequantize_kv(qt, st, torch.float32).numpy(),
        np.asarray(att_jax.dequantize_kv(qj, sj, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,KVH,d,fill", [
    (2, 256, 4, 2, 32, 200),
    (1, 512, 8, 8, 64, 300),
    (2, 256, 16, 1, 256, 130),  # recurrentgemma's MQA, d = 256
])
def test_decode_attention_int8_matches_jax(B, C, H, KVH, d, fill, dtype):
    from repro_torch.models.attention import quantize_kv
    q, k, v = _decode_case(B, C, H, KVH, d, seed=6)
    valid = np.arange(C)[None, :] < np.asarray([[fill]] * B)
    qk, sk = quantize_kv(torch.from_numpy(k).float())
    qv, sv = quantize_kv(torch.from_numpy(v).float())
    qj, qt = both(q, dtype)
    out = da_pt.decode_attention_int8(qt, qk, qv, sk, sv,
                                      torch.from_numpy(valid))
    assert out.dtype == qt.dtype and out.shape == qt.shape
    ref = da_jax.decode_attention_int8_fwd(
        qj, *(jnp.asarray(t.numpy()) for t in (qk, qv, sk, sv)),
        jnp.asarray(valid), interpret=True)
    close(ref, out, dtype)


# ---------------------------------------------------------------------------
# RG-LRU scan


@pytest.mark.parametrize("B,S,W", [(2, 64, 128), (1, 256, 64), (2, 96, 256)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(B, S, W, with_h0):
    rng = np.random.RandomState(3)
    a = (1 / (1 + np.exp(-rng.randn(B, S, W)))).astype(np.float32)
    b = rng.randn(B, S, W).astype(np.float32)
    h0 = rng.randn(B, W).astype(np.float32) if with_h0 else None
    out = lru_pt.rglru_scan(torch.from_numpy(a), torch.from_numpy(b),
                            None if h0 is None else torch.from_numpy(h0))
    assert out.dtype == torch.float32 and out.shape == (B, S, W)
    jh0 = None if h0 is None else jnp.asarray(h0)
    ref = lru_jax.rglru_scan_fwd(jnp.asarray(a), jnp.asarray(b), jh0,
                                 interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(lru_ref_jax(jnp.asarray(a), jnp.asarray(b),
                                            jh0)), rtol=1e-5, atol=1e-5)


def test_rglru_long_dependency():
    """The state carries across the whole sequence (S > the reference's
    256-step blocks)."""
    B, S, W = 1, 600, 128
    a = np.full((B, S, W), 0.999, np.float32)
    b = np.zeros((B, S, W), np.float32)
    b[:, 0] = 1.0
    out = lru_pt.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    ref = lru_jax.rglru_scan_fwd(jnp.asarray(a), jnp.asarray(b),
                                 interpret=True)
    np.testing.assert_allclose(out.numpy()[:, -1], np.asarray(ref)[:, -1],
                               rtol=1e-5)
    np.testing.assert_allclose(out.numpy()[0, -1, 0],
                               np.float64(a[0, 0, 0]) ** (S - 1), rtol=1e-5)


# ---------------------------------------------------------------------------
# device dispatch


def test_cuda_request_without_gpu_raises():
    """Asking for the card where there is none raises; nothing quietly
    runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    model = build_model(get_config("stablelm-3b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)                      # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_paged_cache(4, 16)
    hybrid = build_model(get_config("recurrentgemma-9b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        hybrid.init_cache(2, 16)             # device defaults to "cuda"
    ssm = build_model(get_config("mamba2-2.7b").reduced())
    with pytest.raises(RuntimeError, match="cuda"):
        ssm.init_cache(2, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        from repro_torch.serving.engine import ServingEngine
        ServingEngine(model, model.init(0, device="cpu"))


def test_kernel_launch_counters_ignore_plain_path():
    """The launch counters count kernel launches only: the CPU path runs
    the plain version and leaves them alone."""
    counters = (pa_pt.paged_decode_attention, fa_pt.flash_attention,
                da_pt.decode_attention, da_pt.decode_attention_int8,
                lru_pt.rglru_scan, ssd_pt.ssd_chunked)
    before = [f.launches for f in counters]
    shapes = [dict(f.shapes) for f in counters]
    q, kp, vp, table = _paged_case(1, 8, 2, 2, 2, 16)
    pa_pt.paged_decode_attention(
        *(torch.from_numpy(x).float() for x in (q, kp, vp)),
        torch.from_numpy(table), torch.tensor([5], dtype=torch.int32))
    x = torch.zeros(1, 8, 2, 16)
    fa_pt.flash_attention(x, x, x)
    valid = torch.ones(1, 8, dtype=torch.bool)
    da_pt.decode_attention(x[:, :1], x, x, valid)
    k8 = torch.zeros(1, 8, 2, 16, dtype=torch.int8)
    s = torch.ones(1, 8, 2)
    da_pt.decode_attention_int8(x[:, :1], k8, k8, s, s, valid)
    lru_pt.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8))
    ssd_pt.ssd_chunked(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2),
                       torch.zeros(2), torch.zeros(1, 4, 8),
                       torch.zeros(1, 4, 8), chunk=4)
    assert [f.launches for f in counters] == before
    assert [dict(f.shapes) for f in counters] == shapes


def test_decode_split_plan_covers_the_cache():
    """The split-K plan cuts the cache into whole tiles that cover every
    position: the bf16 tensor-core kernel's 64-position tiles at about one
    block per SM, the f32/int8 kernel's 32-position tiles at two."""
    for B, KVH, C, sms in [(8, 1, 2048, 132), (8, 32, 1024, 132),
                           (1, 1, 100, 132), (2, 4, 256, 8)]:
        for tile, per_sm in ((da_pt.MMA_TILE, 1), (da_pt.TILE, 2)):
            chunk, n = da_pt.split_plan(B, KVH, C, sms, tile=tile,
                                        blocks_per_sm=per_sm)
            assert chunk % tile == 0 and chunk * n >= C
            assert chunk * (n - 1) < C
    assert da_pt.split_plan(8, 1, 2048, 132, tile=da_pt.TILE,
                            blocks_per_sm=2) == (64, 32)


@pytest.mark.parametrize("B,KVH,C", [(8, 1, 2048), (8, 8, 1024),
                                     (1, 1, 2048), (4, 1, 300)])
def test_decode_mma_split_plan_one_block_per_sm(B, KVH, C):
    """The bf16 kernel's plan: chunks that are whole 64-position tiles and
    cover the cache exactly (no chunk empty), about one block per SM where
    the cache is long enough, and at recurrentgemma-9b's ring (B = 8,
    KVH = 1, 2048 slots) half the old plan's partials or fewer."""
    sms = 132
    chunk, n = da_pt.split_plan(B, KVH, C, sms)
    assert chunk % da_pt.MMA_TILE == 0 and chunk % da_pt.MMA_K == 0
    assert chunk * (n - 1) < C <= chunk * n
    blocks = B * KVH * n
    if C >= sms // (B * KVH) * 2 * da_pt.MMA_TILE:
        assert 0.9 * sms <= blocks < 2 * sms, (chunk, n)
    if (B, KVH, C) == (8, 1, 2048):
        assert (chunk, n) == (128, 16)
        old_chunk, old_n = da_pt.split_plan(B, KVH, C, sms, tile=da_pt.TILE,
                                            blocks_per_sm=2)
        assert n * 2 <= old_n


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tile_plan_fits_shared_memory(d, dtype):
    """Every served head dim's tiles fit the 227 KB of shared memory a
    block may use on an H100; bf16's fit two blocks an SM."""
    bq, bk, smem = fa_pt.tile_plan(d, dtype)
    assert smem <= 227 * 1024
    if dtype == torch.bfloat16:
        assert bq == 64 and bk in (32, 64)
        assert smem == (bq + 4 * bk) * (d + 8) * 2
        assert 2 * smem <= 228 * 1024


@pytest.mark.parametrize("d", [72, 88, 100])
def test_bf16_kernels_reject_head_dim_off_the_mma_step(d):
    """The bf16 tensor-core kernels (bf16 q: flash, dense and int8 decode,
    paged decode) take d a multiple of 16: the wrappers' checks raise for
    any other d, with no fallback; the f32 kernels take it."""
    q = torch.zeros(1, 4, 2, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa_pt._check(q, q, q)
    fa_pt._check(q.float(), q.float(), q.float())
    valid = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of 16"):
        da_pt._check(q[:, :1], q, q, valid, torch.bfloat16)
    da_pt._check(q[:, :1].float(), q.float(), q.float(), valid, torch.float32)
    k8 = torch.zeros(1, 4, 2, d, dtype=torch.int8)
    s = torch.ones(1, 4, 2)
    with pytest.raises(ValueError, match="multiple of 16"):
        da_pt._check(q[:, :1], k8, k8, valid, torch.int8, (s, s))
    da_pt._check(q[:, :1].float(), k8, k8, valid, torch.int8, (s, s))
    pool = torch.zeros(3, 8, 2, d, dtype=torch.bfloat16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa_pt._check(q[:, :1], pool, pool, table, lens)
    pa_pt._check(q[:, :1].float(), pool.float(), pool.float(), table, lens)


def test_bf16_kernels_take_served_head_dims():
    """d = 80, 128 and 256 (stablelm-3b, the GQA shape, recurrentgemma-9b)
    pass the bf16 checks, int8 K/V under bf16 q and paged decode too."""
    valid = torch.ones(1, 4, dtype=torch.bool)
    table = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    for d in (80, 128, 256):
        q = torch.zeros(1, 4, 2, d, dtype=torch.bfloat16)
        fa_pt._check(q, q, q)
        da_pt._check(q[:, :1], q, q, valid, torch.bfloat16)
        k8 = torch.zeros(1, 4, 2, d, dtype=torch.int8)
        s = torch.ones(1, 4, 2)
        da_pt._check(q[:, :1], k8, k8, valid, torch.int8, (s, s))
        pool = torch.zeros(3, 8, 2, d, dtype=torch.bfloat16)
        pa_pt._check(q[:, :1], pool, pool, table, lens)


@pytest.mark.parametrize("dtype,G,ok", [
    (torch.float32, 8, True), (torch.float32, 16, False),
    (torch.bfloat16, 16, True), (torch.bfloat16, 32, False)])
def test_paged_group_limit_per_dtype(dtype, G, ok):
    """The f32 paged kernel holds at most 8 query heads per kv head in
    registers; the bf16 one the 16 rows of its mma tile."""
    q = torch.zeros(1, 1, 2 * G, 16, dtype=dtype)
    pool = torch.zeros(3, 8, 2, 16, dtype=dtype)
    args = (q, pool, pool, torch.zeros(1, 2, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
    if ok:
        pa_pt._check(*args)
    else:
        with pytest.raises(ValueError, match="H/KVH"):
            pa_pt._check(*args)



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_wrappers_read_head_narrowed_views(dtype):
    """A shard's run of replicated KV heads is a view of the cache or pool
    narrowed along its heads: the decode and paged wrappers' checks take
    it and give the heads a row holds (the stride the kernels read it
    with, in place), the plain versions read it as they read its copy,
    and a layout the kernels cannot address (slots cut short) is
    refused."""
    rng = np.random.RandomState(3)
    B, C, S, lo, hi, d = 2, 24, 8, 3, 5, 32
    H = 4 * (hi - lo)
    q = torch.as_tensor(rng.randn(B, 1, H, d)).to(dtype)
    k = torch.as_tensor(rng.randn(B, C, S, d)).to(dtype)
    v = torch.as_tensor(rng.randn(B, C, S, d)).to(dtype)
    valid = torch.as_tensor(rng.rand(B, C) < 0.7)
    kr, vr = k[:, :, lo:hi], v[:, :, lo:hi]
    assert da_pt._check(q, kr, vr, valid, dtype) == S
    assert da_pt._check(q, kr.contiguous(), vr.contiguous(), valid,
                        dtype) == hi - lo
    for fn in (da_pt.decode_attention, da_pt.decode_attention_partial):
        torch.testing.assert_close(
            fn(q, kr, vr, valid), fn(q, kr.contiguous(), vr.contiguous(),
                                     valid), rtol=0, atol=0)
    with pytest.raises(ValueError, match="narrowed along its heads"):
        da_pt._check(q, k[:, :C // 2, lo:hi], v[:, :C // 2, lo:hi],
                     valid[:, :C // 2].contiguous(), dtype)
    with pytest.raises(ValueError, match="as many heads"):
        da_pt._check(q, kr, vr.contiguous(), valid, dtype)
    (k8, ks), (v8, vs) = att_pt.quantize_kv(k), att_pt.quantize_kv(v)
    views = (k8[:, :, lo:hi], v8[:, :, lo:hi], ks[:, :, lo:hi],
             vs[:, :, lo:hi])
    assert da_pt._check(q, *views[:2], valid, torch.int8, views[2:]) == S
    torch.testing.assert_close(
        da_pt.decode_attention_int8(q, *views, valid),
        da_pt.decode_attention_int8(q, *(t.contiguous() for t in views),
                                    valid), rtol=0, atol=0)
    with pytest.raises(ValueError, match="as many heads"):
        da_pt._check(q, *views[:2], valid, torch.int8,
                     (views[2].contiguous(), views[3]))
    P, ps, N = 9, 4, 2
    pool_k = torch.as_tensor(rng.randn(P, ps, S, d)).to(dtype)
    pool_v = torch.as_tensor(rng.randn(P, ps, S, d)).to(dtype)
    table = torch.as_tensor(rng.permutation(P - 1)[:B * N].reshape(B, N)
                            + 1).to(torch.int32)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    pk, pv = pool_k[:, :, lo:hi], pool_v[:, :, lo:hi]
    assert pa_pt._check(q, pk, pv, table, lens) == S
    torch.testing.assert_close(
        pa_pt.paged_decode_attention(q, pk, pv, table, lens),
        pa_pt.paged_decode_attention(q, pk.contiguous(), pv.contiguous(),
                                     table, lens), rtol=0, atol=0)
    with pytest.raises(ValueError, match="narrowed along its heads"):
        pa_pt._check(q, pool_k[:, :2, lo:hi], pool_v[:, :2, lo:hi],
                     table, lens)
