"""The bf16 tensor-core decode tiles' algorithms, transcribed into plain
torch, against the JAX kernels and the port's plain versions.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  Here their arithmetic is written
out step by step at the kernels' own granularity -- blocks, 64-position
tiles, 16 positions a warp, online softmax in log2 units, P rounded to
bf16 as the A operand of P V, the block's warp merge and the combine over
the splits -- and held against ``interpret=True`` Pallas kernels and the
plain versions at the kernel tests' tolerances (2e-2 bf16, 2e-5 f32):

* paged decode: split-K over fixed chunks of the page table's reach; a
  chunk that misses a sequence's kept positions never runs, and its
  partial (NaN here) is never read by the combine;
* int8 decode: K and V enter the products as exact integers, k_scale
  multiplies S's columns and v_scale the probabilities before their bf16
  rounding; an invalid slot's scale is never loaded (0), so NaN scales
  there change nothing.
"""

import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.decode_attention import kernel as da_jax  # noqa: E402
from repro.kernels.paged_attention import ops as pa_jax  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_pt  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_pt  # noqa: E402
from repro_torch.models.attention import quantize_kv  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TILE, WARP_KEYS, WARPS = 64, 16, 4
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
EMPTY_MAX = -1.0e30


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(x, name):
    jd, td = DTYPES[name]
    return jnp.asarray(x, jnp.float32).astype(jd), \
        torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(td)


def close(a, b, name):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b.float(), np.float32), **tol(name))


# ---------------------------------------------------------------------------
# the tile, transcribed


def tile_block(q, k, v, keep, scale, *, round_p, k_scale=None,
               v_scale=None):
    """One block of a tile kernel: q [G, d] f32; k, v [n, d] f32 rows in
    the block's order (n a multiple of 64, zeros where not read); keep [n]
    bool; per-key scales [n] or None.  Warp w takes keys 16w .. 16w+15 of
    each 64-key tile with its own (m, l, O) in log2 units; the block
    merges its warps.  → the split's partial (m in natural-log units, l
    [G], acc [G, d])."""
    G, d = q.shape
    m = torch.full((WARPS, G), -math.inf)
    l = torch.zeros(WARPS, G)
    o = torch.zeros(WARPS, G, d)
    for t0 in range(0, k.shape[0], TILE):
        for w in range(WARPS):
            sl = slice(t0 + w * WARP_KEYS, t0 + (w + 1) * WARP_KEYS)
            if not keep[sl].any():
                continue                    # the warp skips the group
            s = q @ k[sl].T                                   # [G, 16]
            if k_scale is not None:
                s = s * k_scale[sl]
            s = torch.where(keep[sl], s, -math.inf) * (scale * LOG2E)
            m_new = torch.maximum(m[w], s.max(1).values)
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m[w] - m_use)
            p = torch.exp2(s - m_use[:, None])
            l[w] = l[w] * alpha + p.sum(1)
            if v_scale is not None:
                p = p * v_scale[sl]
            if round_p:                     # the A operand of P V
                p = p.to(torch.bfloat16).float()
            o[w] = o[w] * alpha[:, None] + p @ v[sl]
            m[w] = m_new
    mx = m.max(0).values
    seen = mx != -math.inf
    c = torch.exp2(m - torch.where(seen, mx, 0.0))
    lsum = torch.where(seen, (l * c).sum(0), 0.0)
    acc = torch.where(seen[:, None], (o * c[:, :, None]).sum(0), 0.0)
    return torch.where(seen, mx * LN2, EMPTY_MAX), lsum, acc


def combine(parts, live):
    """The combine kernel over one (b, kv head)'s partials (a list, one
    per split, (m, l, acc) each); only the splits in ``live`` are read."""
    if not live:
        return None
    ms = torch.stack([parts[s][0] for s in live])            # [S, G]
    mx = torch.maximum(ms.max(0).values, torch.tensor(EMPTY_MAX))
    c = torch.exp(ms - mx)
    lsum = (torch.stack([parts[s][1] for s in live]) * c).sum(0)
    acc = (torch.stack([parts[s][2] for s in live]) * c[:, :, None]).sum(0)
    return acc / torch.clamp(lsum, min=1e-30)[:, None]


def kept_range(length, cap, window):
    """(start, len): the reference's window counts from the uncapped
    length."""
    n = min(max(length, 0), cap)
    return min(length - window if window > 0 and length > window else 0,
               n), n


def paged_transcription(q, kp, vp, table, lengths, *, window=0):
    """paged_mma_kernel + the combine, on [B,1,H,d] q and [P,ps,KVH,d]
    pools: a grid of (N*ps / CHUNK, KVH, B) blocks, the dead ones never
    run (their partials stay NaN), each live block stages its chunk's
    pool rows (-1 where it must not read) and walks its tiles from the
    first one that reaches ``start``."""
    B, _, H, d = q.shape
    P, ps, KVH, _ = kp.shape
    N = table.shape[1]
    G = H // KVH
    chunk, n_split = pa_pt.CHUNK, pa_pt.split_plan(N, ps)
    round_p = q.dtype == torch.bfloat16
    qf, kf, vf = q.float(), kp.float(), vp.float()
    out = torch.zeros(B, H, d)
    for b in range(B):
        start, n = kept_range(int(lengths[b]), N * ps, window)
        for h in range(KVH):
            nan = torch.full((G,), math.nan)
            parts = [(nan, nan, torch.full((G, d), math.nan))] * n_split
            for s in range(n_split):
                j0 = s * chunk
                if not (j0 < n and j0 + chunk > start):
                    continue                # exits at once, writes nothing
                slots = []
                for j in range(j0, j0 + chunk):
                    page = int(table[b, j // ps]) if start <= j < n else -1
                    slots.append(page * ps + j % ps if 0 <= page < P else -1)
                first = j0 + (max(start, j0) - j0) // TILE * TILE
                stop = j0 + -(-(min(j0 + chunk, n) - j0) // TILE) * TILE
                sl = torch.tensor(slots[first - j0:stop - j0],
                                  dtype=torch.long)
                keep = sl >= 0
                rows = torch.where(keep, sl, 0)
                flat = lambda t: t.reshape(P * ps, KVH, d)[rows, h]  # noqa
                zero = lambda t: torch.where(keep[:, None], t, 0.0)  # noqa
                parts[s] = tile_block(
                    qf[b, 0, h * G:(h + 1) * G], zero(flat(kf)),
                    zero(flat(vf)), keep, d ** -0.5, round_p=round_p)
            live = [s for s in range(n_split)
                    if s * chunk < n and s * chunk + chunk > start]
            o = combine(parts, live)
            if o is not None:
                out[b, h * G:(h + 1) * G] = o
    return out.reshape(B, 1, H, d).to(q.dtype)


def int8_transcription(q, k8, v8, k_scale, v_scale, valid, *, num_sms=8):
    """decode_int8_mma_kernel + the combine: the bf16 kernels' split plan
    (one block per SM of ``num_sms``), int8 rows as exact integers, an
    invalid slot's rows and scales zero (never loaded)."""
    B, _, H, d = q.shape
    C, KVH = k8.shape[1], k8.shape[2]
    G = H // KVH
    chunk, n_split = da_pt.split_plan(B, KVH, C, num_sms)
    round_p = q.dtype == torch.bfloat16
    out = torch.zeros(B, H, d)
    for b in range(B):
        for h in range(KVH):
            parts = []
            for s in range(n_split):
                j0, j1 = s * chunk, min(C, s * chunk + chunk)
                stop = j0 + -(-(j1 - j0) // TILE) * TILE
                keep = torch.zeros(stop - j0, dtype=torch.bool)
                keep[:j1 - j0] = valid[b, j0:j1]
                pad = stop - j1

                def rows(t):
                    x = torch.nn.functional.pad(t[b, j0:j1, h].float(),
                                                (0, 0, 0, pad))
                    return torch.where(keep[:, None], x, 0.0)

                def scales(t):
                    x = torch.nn.functional.pad(t[b, j0:j1, h], (0, pad))
                    return torch.where(keep, x, 0.0)

                parts.append(tile_block(
                    q[b, 0, h * G:(h + 1) * G].float(), rows(k8), rows(v8),
                    keep, d ** -0.5, round_p=round_p,
                    k_scale=scales(k_scale), v_scale=scales(v_scale)))
            out[b, h * G:(h + 1) * G] = combine(parts, list(range(n_split)))
    return out.reshape(B, 1, H, d).to(q.dtype)


# ---------------------------------------------------------------------------
# the paged split plan


@pytest.mark.parametrize("N,ps", [(64, 16), (128, 8), (32, 32), (3, 16),
                                  (1, 1), (5, 7)])
def test_paged_split_plan_covers_the_table(N, ps):
    """The splits are whole 64-position tiles that cover the table's
    reach of N * ps positions, the last one not empty."""
    n, chunk = pa_pt.split_plan(N, ps), pa_pt.CHUNK
    assert chunk % pa_pt.MMA_TILE == 0
    assert chunk * n >= N * ps > chunk * (n - 1)


def test_paged_split_plan_never_sees_the_lengths():
    """The plan is a function of the table's width and page size alone
    (the lengths stay on the device); at the serve phase's table (64 pages
    of 16) it gives 8 splits of 128 positions."""
    assert list(inspect.signature(pa_pt.split_plan).parameters) \
        == ["N", "ps"]
    assert pa_pt.split_plan(64, 16) == 8


def test_paged_chunk_matches_the_kernel():
    """The wrapper's CHUNK is the CUDA kernel's compile-time kChunk (the
    kernel refuses any other split count)."""
    src = (Path(pa_pt.__file__).parent / "csrc"
           / "paged_attention.cu").read_text()
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) \
        == str(pa_pt.CHUNK)


# ---------------------------------------------------------------------------
# paged decode, transcribed, against the Pallas kernel and the plain version


def _paged_case(B, ps, N, H, KVH, d, seed=4):
    rng = np.random.RandomState(seed)
    P = B * N + 3
    q = rng.randn(B, 1, H, d)
    kp = rng.randn(P, ps, KVH, d)
    vp = rng.randn(P, ps, KVH, d)
    table = (rng.permutation(P - 1)[: B * N] + 1).reshape(B, N)
    return q, kp, vp, table.astype(np.int32)


def _paged_check(q, kp, vp, table, lengths, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype) for x in (q, kp, vp))
    lens = np.asarray(lengths, np.int32)
    got = paged_transcription(qt, kt, vt, torch.from_numpy(table),
                              torch.from_numpy(lens), window=window)
    assert torch.isfinite(got.float()).all()
    close(pa_jax.paged_decode_attention(
        qj, kj, vj, jnp.asarray(table), jnp.asarray(lens), window=window,
        interpret=True), got, dtype)
    close(pa_pt.paged_decode_attention(
        qt, kt, vt, torch.from_numpy(table), torch.from_numpy(lens),
        window=window).float().numpy(), got, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,ps,N,H,KVH,d,lengths,window", [
    (2, 16, 4, 4, 4, 32, (64, 37), 0),   # full + ragged last page
    (2, 8, 6, 8, 2, 64, (48, 41), 0),    # GQA 4:1, small pages
    (1, 32, 3, 4, 1, 32, (70,), 0),      # MQA, big pages, ragged
    (2, 16, 4, 4, 4, 32, (64, 50), 24),  # sliding window across pages
    (1, 16, 2, 2, 2, 16, (1,), 0),       # single valid token
    (2, 16, 3, 5, 1, 80, (33, 40), 0),   # stablelm head_dim, G=5
    (2, 16, 20, 4, 2, 32, (300, 129), 0),  # three splits, one ragged
])
def test_paged_split_k_matches_jax(B, ps, N, H, KVH, d, lengths, window,
                                   dtype):
    """The shapes of the kernel tests, and one that spans three splits,
    through split-K over fixed chunks and the length-aware combine."""
    _paged_check(*_paged_case(B, ps, N, H, KVH, d), lengths, window, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_k_skips_splits_outside_the_window(dtype):
    """A window that leaves whole chunks before ``start`` (their blocks
    exit, the combine skips them), a length short of the table's reach
    (chunks past it skip too), an empty row and a length past the reach
    (capped at N * ps)."""
    B, ps, N, H, KVH, d = 4, 8, 24, 4, 2, 32
    q, kp, vp, table = _paged_case(B, ps, N, H, KVH, d, seed=7)
    _paged_check(q, kp, vp, table, (190, 70, 0, 500), 40, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_k_retired_rows_and_stale_pages(dtype):
    """Retired slots (table all scratch page 0, stale length) stay finite
    and equal the reference; NaN in every pool row no kept position reads
    leaves the transcription's output bit for bit."""
    B, ps, N, H, KVH, d = 3, 8, 32, 4, 2, 32
    q, kp, vp, table = _paged_case(B, ps, N, H, KVH, d, seed=9)
    table[1] = 0
    table[2] = 0
    lengths = (200, 17, N * ps)
    _paged_check(q, kp, vp, table, lengths, 0, dtype)
    _, qt = both(q, dtype)
    args = (torch.from_numpy(table), torch.from_numpy(
        np.asarray(lengths, np.int32)))
    clean = paged_transcription(qt, *(both(x, dtype)[1] for x in (kp, vp)),
                                *args)
    read = np.zeros(kp.shape[:2], bool)
    for b, n in enumerate(lengths):
        for j in range(min(n, N * ps)):
            read[table[b, j // ps], j % ps] = True
    kp[~read] = np.nan
    vp[~read] = np.nan
    dirty = paged_transcription(qt, *(both(x, dtype)[1] for x in (kp, vp)),
                                *args)
    assert torch.equal(clean, dirty)


# ---------------------------------------------------------------------------
# int8 decode, transcribed


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,KVH,d,fill", [
    (2, 256, 4, 2, 32, 200),
    (1, 512, 8, 8, 64, 300),
    (2, 256, 16, 1, 256, 130),  # recurrentgemma's MQA, d = 256
])
def test_int8_tile_matches_jax(B, C, H, KVH, d, fill, dtype):
    """The shapes of the int8 kernel test, through the tile with the
    scales on S's columns and on P, and NaN scales in every invalid slot:
    against the Pallas kernel and the plain version, and bit-equal to the
    same inputs with finite scales there."""
    rng = np.random.RandomState(6)
    q = rng.randn(B, 1, H, d)
    k = rng.randn(B, C, KVH, d)
    v = rng.randn(B, C, KVH, d)
    valid = np.arange(C)[None, :] < np.asarray([[fill]] * B)
    valid[0, 5] = False                 # a hole inside the filled part
    qk, sk = quantize_kv(torch.from_numpy(k).float())
    qv, sv = quantize_kv(torch.from_numpy(v).float())
    vt = torch.from_numpy(valid)
    qj, qt = both(q, dtype)
    clean = int8_transcription(qt, qk, qv, sk, sv, vt)
    sk[~vt] = math.nan
    sv[~vt] = math.nan
    got = int8_transcription(qt, qk, qv, sk, sv, vt)
    assert torch.equal(clean, got)
    close(da_jax.decode_attention_int8_fwd(
        qj, *(jnp.asarray(t.numpy()) for t in (qk, qv, sk, sv)),
        jnp.asarray(valid), interpret=True), got, dtype)
    close(da_pt.decode_attention_int8(qt, qk, qv, sk, sv, vt)
          .float().numpy(), got, dtype)
