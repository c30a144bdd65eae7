"""The two scan kernels' algorithms, transcribed into plain torch, against
the JAX kernels and oracles.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  Here their arithmetic is written
out at the kernels' own granularity and held on the CPU against the
``interpret=True`` Pallas kernels, the JAX oracles and, at the serving
model's decay, a float64 recurrence:

* the SSD chunk scan (``kernels/ssd/csrc/ssd.cu``): chunks of
  ``KERNEL_CHUNK`` steps; each chunk's own state ``Bᵀ(w∘xdt)`` with ``w``
  from a suffix scan (lanes of 4 steps, then across lanes); the sequential
  pass over chunk states; ``C·Bᵀ`` once a chunk for all heads; each
  chunk's output as one accumulator over ``exp(cum)∘(C·h_in)`` and
  ``(L∘C·Bᵀ)·xdt``, with L's segment sums formed in blocks of 8 rows.  (The
  kernel skips the products whose decay underflowed to 0; they add exact
  zeros, so the transcription forms them.)  Every
  product is the kernel's 3xTF32 form: each f32 operand split into ``hi =
  tf32(x)`` and ``lo = tf32(x - hi)``, rounded to 10 mantissa bits to
  nearest with ties away from zero (``cvt.rna.tf32.f32``), and each 8-deep
  step's ``lo·hi + hi·lo + hi·hi`` added to the accumulator in f32.
  Tolerance 2e-4, that of the SSD kernel tests;
* the RG-LRU scan (``kernels/rglru/csrc/rglru.cu``): tiles of ``TILE``
  steps cut into segments of ``SEGMENT``; each segment folded from zero
  into (prod a, b aggregate), the aggregates of the segments before it
  applied in order to the tile's carry, the segment run again from its
  carry-in; the tile's last state carried on.  Tolerance 2e-5, that of
  the f32 kernel tests.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.rglru import kernel as lru_jax  # noqa: E402
from repro.kernels.rglru.ref import rglru_scan_ref as lru_ref_jax  # noqa: E402
from repro.kernels.ssd import ops as ssd_jax  # noqa: E402
from repro.models import ssd as ssd_model_jax  # noqa: E402
from repro_torch.kernels.rglru import ops as lru_pt  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_pt  # noqa: E402

KERNELS = Path(lru_pt.__file__).resolve().parent.parent
KTOL = dict(rtol=2e-4, atol=2e-4)
LTOL = dict(rtol=2e-5, atol=2e-5)
KSTEP = 8          # the depth of one mma.m16n8k8


def cu_constant(kernel, name):
    src = (KERNELS / kernel / "csrc" / f"{kernel}.cu").read_text()
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


# ---------------------------------------------------------------------------
# 3xTF32


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the dropped 13 bits' range to the magnitude and
    clear them (the sign bit is apart, so this rounds away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b, acc=None):
    """acc + a @ b as the kernel forms it: K in steps of 8, each step's
    lo·hi + hi·lo + hi·hi summed from zero and added to acc in f32."""
    K = a.shape[-1]
    pad = (-K) % KSTEP
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1]) if acc is None else acc
    for k in range(0, K + pad, KSTEP):
        s = slice(k, k + KSTEP)
        part = al[..., s] @ bh[..., s, :]
        part = part + ah[..., s] @ bl[..., s, :]
        part = part + ah[..., s] @ bh[..., s, :]
        out = out + part
    return out


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0, -0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp,
                                3.0, -0.0]


def test_split_keeps_float32_and_one_product_does_not():
    """hi + lo holds x to ~2^-22; the 3xTF32 dot product of 128 terms is as
    close to float64 as float32's own, and plain TF32 is ~1000x further."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(64, 128, generator=gen)
    b = torch.randn(128, 64, generator=gen)
    hi, lo = split(a)
    assert ((hi + lo - a).abs() <= 2.0 ** -22 * a.abs()).all()
    exact = a.double() @ b.double()
    err3 = (mm3(a, b).double() - exact).abs().max().item()
    err32 = ((a @ b).double() - exact).abs().max().item()
    err1 = ((tf32(a) @ tf32(b)).double() - exact).abs().max().item()
    assert err3 < 3 * err32 and err1 > 100 * err3


# ---------------------------------------------------------------------------
# the SSD chunk scan, transcribed


def suffix_after(da):
    """[..., Q] → Σ_{k>j} da_k, as the kernel's warp forms it: each lane
    sums its 4 steps from the end, the lanes above by a suffix scan."""
    v = da.reshape(*da.shape[:-1], -1, 4)
    after = torch.stack([v[..., 3] + v[..., 2] + v[..., 1],
                         v[..., 3] + v[..., 2], v[..., 3],
                         torch.zeros_like(v[..., 3])], dim=-1)
    lane = after[..., 0] + v[..., 0]
    above = torch.flip(torch.cumsum(torch.flip(lane, [-1]), -1), [-1])
    above = torch.nn.functional.pad(above[..., 1:], (0, 1))
    total = above[..., 0] + lane[..., 0]
    return (above[..., None] + after).reshape(da.shape), total


def prefix_cum(da):
    """[..., Q] → Σ_{k≤i} da_k: each lane's 4 steps, the lanes below by a
    prefix scan."""
    v = da.reshape(*da.shape[:-1], -1, 4)
    upto = torch.cumsum(v, -1)
    below = torch.cumsum(upto[..., 3], -1)
    below = torch.nn.functional.pad(below[..., :-1], (1, 0))
    return (below[..., None] + upto).reshape(da.shape)


def column_segments(da):
    """[Q] → [Q, Q]: row i, column j holds Σ_{j<k≤i} da_k (0 on and above
    the diagonal), formed as the kernel forms it in blocks of 8 rows: in
    j's own block one step at a time from j + 1; in a block b below it,
    R + tpre[i], with tpre the sum over i's block up to i and R the suffix
    of j's block plus the totals of the blocks between, added in order."""
    Q = da.shape[-1]
    tpre = torch.cumsum(da.reshape(-1, 8), -1).reshape(Q)
    seg = torch.zeros(Q, Q)
    for j in range(Q):
        bj = j // 8
        s = torch.zeros(())
        for i in range(j + 1, 8 * bj + 8):
            s = s + da[i]
            seg[i, j] = s
        R = s
        for b in range(bj + 1, Q // 8):
            rows = slice(8 * b, 8 * b + 8)
            seg[rows, j] = R + tpre[rows]
            R = R + tpre[8 * b + 7]
    return seg


def ssd_tiles(xh, dt, a_log, B, C, initial_state=None):
    """The kernel's algorithm on [b,S,H,P] / [b,S,N] float32 tensors.
    → (y [b,S,H,P], final state [b,H,P,N])."""
    Q = ssd_pt.KERNEL_CHUNK
    b, S, H, P = xh.shape
    N = B.shape[-1]
    A = -torch.exp(a_log)
    da = dt * A
    xdt = xh * dt[..., None]
    nc = -(-S // Q)
    pad = nc * Q - S
    pad_s = lambda t: torch.nn.functional.pad(   # noqa: E731
        t, (0, 0) * (t.dim() - 2) + (0, pad))
    xdt, da, Bp, Cp = pad_s(xdt), pad_s(da), pad_s(B), pad_s(C)
    y = torch.zeros(b, nc * Q, H, P)
    hout = torch.zeros(b, H, N, P)
    for bi in range(b):
        # 1. chunk states from zero, chunk totals; C.B^T once a chunk
        states, tots, cbs = [], [], []
        for c in range(nc):
            s = slice(c * Q, (c + 1) * Q)
            w, tot = suffix_after(da[bi, s].T)              # [H, Q], [H]
            Bc = Bp[bi, s]                                  # [Q, N]
            states.append(torch.stack([
                mm3(Bc.T, torch.exp(w[h])[:, None] * xdt[bi, s, h])
                for h in range(H)]))                        # [H, N, P]
            tots.append(tot)
            cbs.append(mm3(Cp[bi, s], Bc.T))                # [Q, Q]
        # 2. the pass over chunks
        h_in = []
        hcur = torch.zeros(H, N, P) if initial_state is None \
            else initial_state[bi].transpose(-1, -2)
        for c in range(nc):
            h_in.append(hcur)
            hcur = torch.exp(tots[c])[:, None, None] * hcur + states[c]
        hout[bi] = hcur
        # 3. each chunk's output
        has_h0 = initial_state is not None
        for c in range(nc):
            s = slice(c * Q, (c + 1) * Q)
            for h in range(H):
                dah = da[bi, s, h]
                acc = torch.zeros(Q, P)
                if c > 0 or has_h0:
                    acc = mm3(Cp[bi, s], h_in[c][h]) \
                        * torch.exp(prefix_cum(dah))[:, None]
                i = torch.arange(Q)[:, None]
                j = torch.arange(Q)[None, :]
                G = torch.where(j < i, torch.exp(column_segments(dah))
                                * cbs[c], torch.where(j == i, cbs[c], 0.0))
                y[bi, s, h] = mm3(G, xdt[bi, s, h], acc)
    return y[:, :S], hout.transpose(-1, -2)


def _ssd_inputs(seed, B, S, H, P, N, a_scale=0.5, a_shift=0.0, h0=False):
    rng = np.random.RandomState(seed)
    xh = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    a_log = (rng.randn(H) * a_scale + a_shift).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    state = rng.randn(B, H, P, N).astype(np.float32) if h0 else None
    return xh, dt, a_log, Bm, Cm, state


def _torch(v):
    return None if v is None else torch.from_numpy(v)


def _jax(v):
    return None if v is None else jnp.asarray(v)


@pytest.mark.parametrize("B,S,H,P,N,h0", [
    (1, 256, 2, 16, 16, False),      # two whole kernel chunks
    (2, 128, 2, 8, 8, True),         # one chunk, two batch rows, a state
])
def test_ssd_tiles_match_pallas_kernel(B, S, H, P, N, h0):
    """At chunk-multiple lengths, against the Pallas kernel in interpret
    mode at the model's chunk of 128."""
    inputs = _ssd_inputs(4, B, S, H, P, N, h0=h0)
    y, hs = ssd_tiles(*(_torch(v) for v in inputs))
    yj, hj = ssd_jax.ssd_chunked(*(_jax(v) for v in inputs[:5]), chunk=128,
                                 initial_state=_jax(inputs[5]),
                                 interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hj), **KTOL)


@pytest.mark.parametrize("S,h0", [(2, False), (37, True), (200, False)])
def test_ssd_tiles_ragged_match_oracle(S, h0):
    """Lengths under a chunk and with a ragged tail (zeros with da = 0
    past S), against the JAX oracle at the model's chunk."""
    inputs = _ssd_inputs(5, 1, S, 2, 8, 8, h0=h0)
    y, hs = ssd_tiles(*(_torch(v) for v in inputs))
    yj, hj = ssd_model_jax.ssd_chunked_ref(
        *(_jax(v) for v in inputs[:5]), chunk=256,
        initial_state=_jax(inputs[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hj), **KTOL)


def test_ssd_tiles_strong_decay_stays_finite():
    """An in-chunk cumulative log decay far below -100: exp(cum) and the
    far decays underflow to 0, never to 0/0."""
    inputs = _ssd_inputs(6, 1, 160, 2, 8, 8, a_scale=0.0, a_shift=2.5)
    xh, dt, a_log = inputs[:3]
    assert np.cumsum(dt[0, :128] * -np.exp(a_log), axis=0).min() < -100
    y, hs = ssd_tiles(*(_torch(v) for v in inputs))
    assert torch.isfinite(y).all() and torch.isfinite(hs).all()
    yj, hj = ssd_model_jax.ssd_chunked_ref(
        *(_jax(v) for v in inputs[:5]), chunk=128)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), **KTOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(hj), **KTOL)


def test_ssd_tiles_hold_float64_recurrence():
    """At the serving model's decay (a_log = 1, dt = softplus(N(0, 1)))
    and state size (N = 128), over two chunks with the cumulative log decay
    far below -100, against h_t = exp(dt·A)·h + dt·x⊗B, y_t = h·C in
    float64."""
    S, H, P, N = 256, 1, 8, 128
    xh, dt, a_log, Bm, Cm, _ = _ssd_inputs(8, 1, S, H, P, N, a_scale=0.0,
                                           a_shift=1.0)
    da = dt[0].astype(np.float64) * -np.exp(a_log.astype(np.float64))
    assert np.cumsum(da[:128], axis=0).min() < -100
    h = np.zeros((H, P, N))
    y64 = np.zeros((S, H, P))
    for s in range(S):
        h = np.exp(da[s])[:, None, None] * h + \
            (xh[0, s] * dt[0, s][:, None])[:, :, None] * Bm[0, s]
        y64[s] = h @ Cm[0, s]
    y, state = ssd_tiles(*(_torch(v) for v in (xh, dt, a_log, Bm, Cm)))
    np.testing.assert_allclose(y[0].numpy(), y64, **KTOL)
    np.testing.assert_allclose(state[0].numpy(), h, **KTOL)


def test_ssd_constants_match_the_kernel():
    """The wrapper's chunk and limits are the CUDA source's constants
    (``chip_smoke.py``'s strong-decay row reads KERNEL_CHUNK)."""
    assert int(cu_constant("ssd", "kQ")) == ssd_pt.KERNEL_CHUNK
    assert int(cu_constant("ssd", "kP")) == ssd_pt.MAX_HEADDIM
    assert int(cu_constant("ssd", "kN")) == ssd_pt.MAX_STATE
    assert ssd_pt.KERNEL_CHUNK % 32 == 0


@pytest.mark.parametrize("kernel,ops", [("ssd", ssd_pt), ("rglru", lru_pt)])
def test_ctypes_signatures_match_the_entry_points(kernel, ops):
    """Each C entry point's parameters, pointers and ints in order, are the
    wrapper's ctypes argtypes (a pointer passed where the kernel takes
    another argument would be read as garbage, not refused)."""
    import ctypes
    src = (KERNELS / kernel / "csrc" / f"{kernel}.cu").read_text()
    for fn, argtypes in ops._SIGNATURES.items():
        params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
        kinds = [ctypes.c_int if re.fullmatch(r"int \w+", p.strip())
                 else ctypes.c_void_p for p in params.split(",")]
        assert all(re.fullmatch(r"(const )?(void|float)\* \w+|int \w+",
                                p.strip()) for p in params.split(","))
        assert kinds == list(argtypes)


# ---------------------------------------------------------------------------
# the RG-LRU scan, transcribed


def rglru_tiles(a, b, h0=None):
    """The kernel's algorithm on [B, S, W] float32: every channel at once."""
    T, L = lru_pt.TILE, lru_pt.SEGMENT
    Bn, S, W = a.shape
    pad = (-S) % T
    # rows past S are copied as zeros and never written
    a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    out = torch.empty_like(a)
    carry = torch.zeros(Bn, W) if h0 is None else h0.clone()
    for t0 in range(0, S + pad, T):
        ta = a[:, t0:t0 + T].reshape(Bn, T // L, L, W)
        tb = b[:, t0:t0 + T].reshape(Bn, T // L, L, W)
        # 1. each segment folded from zero
        pa = torch.ones(Bn, T // L, W)
        pb = torch.zeros(Bn, T // L, W)
        for i in range(L):
            pb = pb * ta[:, :, i] + tb[:, :, i]
            pa = pa * ta[:, :, i]
        # 2. carry into each segment, in order, and out of the tile
        hin = torch.empty(Bn, T // L, W)
        for s in range(T // L):
            hin[:, s] = carry
            carry = pa[:, s] * carry + pb[:, s]
        # 3. each segment again from its carry-in
        h = hin
        for i in range(L):
            h = ta[:, :, i] * h + tb[:, :, i]
            out[:, t0:t0 + T].view(Bn, T // L, L, W)[:, :, i] = h
    return out[:, :S]


@pytest.mark.parametrize("S", [1, 2, 37, 256, 129],
                         ids=["S1", "S2", "S37", "two_tiles", "tile_plus_1"])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_tiles_match_jax(S, with_h0):
    """Lengths of one step, inside a segment, inside a tile, a tile
    multiple and one past a tile, with and without a carried state, against
    the Pallas kernel in interpret mode and the JAX oracle; W = 40 is not a
    multiple of the kernel's 32 channels a block."""
    B, W = 2, 40
    rng = np.random.RandomState(11)
    a = (1 / (1 + np.exp(-rng.randn(B, S, W)))).astype(np.float32)
    b = rng.randn(B, S, W).astype(np.float32)
    h0 = rng.randn(B, W).astype(np.float32) if with_h0 else None
    out = rglru_tiles(torch.from_numpy(a), torch.from_numpy(b), _torch(h0))
    ref = lru_jax.rglru_scan_fwd(jnp.asarray(a), jnp.asarray(b), _jax(h0),
                                 interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LTOL)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(lru_ref_jax(jnp.asarray(a), jnp.asarray(b),
                                            _jax(h0))), **LTOL)


def test_rglru_tiles_carry_a_long_dependency():
    """A state set at step 0 decays through every segment and tile
    boundary: after 600 steps of a = 0.999 it is 0.999^599."""
    B, S, W = 1, 600, 8
    a = torch.full((B, S, W), 0.999)
    b = torch.zeros(B, S, W)
    b[:, 0] = 1.0
    out = rglru_tiles(a, b)
    np.testing.assert_allclose(out[0, -1].numpy(), 0.999 ** 599, rtol=2e-5)


def test_rglru_constants_match_the_kernel():
    """The wrapper's tile, segment and channel counts are the CUDA
    source's: a segment a warp, a channel a lane."""
    assert int(cu_constant("rglru", "kChannels")) == lru_pt.CHANNELS
    assert int(cu_constant("rglru", "kTile")) == lru_pt.TILE
    warps = int(cu_constant("rglru", "kWarps"))
    assert cu_constant("rglru", "kSeg") == "kTile / kWarps"
    assert lru_pt.TILE // warps == lru_pt.SEGMENT
    assert lru_pt.CHANNELS == 32 and lru_pt.TILE % lru_pt.SEGMENT == 0
