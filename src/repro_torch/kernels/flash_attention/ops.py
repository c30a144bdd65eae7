"""Flash attention forward with an optional padded prefix: wrapper of the
CUDA kernel.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``
(Pallas ``_fa_kernel``) and extends it with the serving engine's prefix
mode, so prefix-aware prefill runs in this kernel too.  CPU tensors take
the plain version (:mod:`.ref`); CUDA tensors launch
``csrc/flash_attention.cu`` or raise.

Gradients follow the reference's custom VJP
(``repro/kernels/flash_attention/ops.py``): the forward is this wrapper's,
and the backward (:func:`flash_attention_vjp`) recomputes attention from
the saved ``q, k, v`` through the plain version and differentiates that,
on either device (the reference computes its backward in XLA, outside any
kernel), under the same mask: the reference's causal and window masks
and the prefix mode alike.  The engine's prefix-aware prefill runs under
no gradient; a ``ulysses_sp`` shard's queries, which start ``r·S/tp``
rows into the sequence, train through the prefix mode
(``prefix_pad = prefix_len = r·S/tp``), whose window reaches back into
the prefix rows.

On ``meta`` tensors (the dry-run) the wrapper runs nothing: it returns
an empty output and hands :func:`flash_attention_work` to the meter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

from .ref import flash_attention_ref

MAX_HEAD_DIM = 256
MMA_K = 16        # the bf16 kernel's mma k-step: d must be a multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"flash_attention_fwd":
               [_I, _P, _P, _P, _P] + [_I] * 10 + [_F, _P],
               "flash_attention_smem_bytes": [_I, _I]}


def tile_plan(d, dtype):
    """(queries per block, keys per K/V tile, dynamic shared memory bytes)
    of the kernel at head dim ``d``: bf16 stages a 64-query tile and two
    K and two V tiles of 64 keys (32 at d > 128) in rows padded by 16
    bytes; f32 a 32-query tile and one K (padded by one float) and one V
    tile of 32 keys.  ``flash_attention_smem_bytes`` in the CUDA source
    gives the same bytes."""
    if dtype == torch.bfloat16:
        bq, bk = 64, (64 if d <= 128 else 32)
        return bq, bk, (bq + 4 * bk) * (d + 8) * 2
    return 32, 32, (32 * d + 32 * (d + 1) + 32 * d) * 4


def _check(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    B, S, H, d = q.shape
    Bk, T, KVH, dk = k.shape
    if Bk != B or dk != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if H % KVH or d > MAX_HEAD_DIM:
        raise ValueError(f"H={H}, KVH={KVH}, d={d}: the kernel takes "
                         f"H % KVH == 0 and d <= {MAX_HEAD_DIM}")
    mma = q.dtype == torch.bfloat16
    if mma and d % MMA_K:
        raise ValueError(f"d={d}: the bfloat16 kernel takes d a multiple "
                         f"of {MMA_K}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if mma and t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             f"bf16 kernel copies rows 16 bytes at a time)")


def launch_key(q, k, *, causal=True, window=0, prefix_pad=0,
               prefix_len=0) -> tuple:
    """((field, value), ...) of a launch: its dtype, shapes and mask."""
    B, S, H, d = q.shape
    return (("dtype", _build.dtype_name(q.dtype)), ("B", B), ("S", S),
            ("T", k.shape[1]), ("H", H), ("KVH", k.shape[2]), ("d", d),
            ("causal", bool(causal)), ("window", int(window)),
            ("prefix_pad", int(prefix_pad)), ("prefix_len", int(prefix_len)))


def kept_pairs(S, T, *, causal=True, window=0, prefix_pad=0,
               prefix_len=0) -> tuple:
    """(query-key pairs kept, K/V rows some query keeps) of
    :func:`~.ref.keep_mask` at these arguments, counted without forming
    the mask: query i keeps the valid prefix rows ``[plo_i, prefix_len)``
    (all of them without a window) and its own rows ``rel = j -
    prefix_pad`` in ``[lo_i, hi_i]``; the padding rows past
    ``prefix_len`` are never read."""
    own = T - prefix_pad
    i = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(own - 1, i) if causal else np.full_like(i, own - 1)
    n = np.maximum(0, hi - lo + 1)
    some = n > 0
    rows = int(hi[some].max() - lo[some].min() + 1) if some.any() else 0
    plo = np.minimum(np.maximum(0, prefix_len + i - window + 1), prefix_len) \
        if window > 0 else np.zeros_like(i)
    pre = prefix_len - plo
    return (int(n.sum() + pre.sum()),
            rows + (int(pre.max()) if S else 0))


def flash_attention_work(q, k, *, causal=True, window=0, prefix_pad=0,
                         prefix_len=0) -> tuple:
    """(bytes, flops) of one call: q read and the output written once,
    each K and V row some query keeps read once; 4·d multiply-adds a kept
    (query head, key) pair (q·k and p·v)."""
    B, S, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs, rows = kept_pairs(S, T, causal=causal, window=window,
                             prefix_pad=prefix_pad, prefix_len=prefix_len)
    return ((2 * q.numel() + 2 * B * rows * KVH * d) * es,
            4 * B * H * d * pairs)


@_build.counted
def flash_attention(q, k, v, *, causal=True, window=0, prefix_pad=0,
                    prefix_len=0):
    """q: [B,S,H,d]; k,v: [B,T,KVH,d] → [B,S,H,d].

    Keys are the ``prefix_pad`` rows of a padded prefix followed by the
    queries' own rows.  Query i keeps key j iff j < prefix_len and
    j > prefix_len + i - window (when window > 0), or j >= prefix_pad
    and j - prefix_pad <= i (when causal) and j - prefix_pad > i - window
    (when window > 0).  ``prefix_pad`` and
    ``prefix_len`` are host ints (the engine knows them); with both 0
    this is the reference kernel's causal/window attention.  Every form
    takes a gradient."""
    prefix_pad, prefix_len = int(prefix_pad), int(prefix_len)
    if not 0 <= prefix_len <= prefix_pad <= k.shape[1]:
        raise ValueError(f"need 0 <= prefix_len ({prefix_len}) <= prefix_pad "
                         f"({prefix_pad}) <= T ({k.shape[1]})")
    mask = (bool(causal), int(window), prefix_pad, prefix_len)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask)
    return _forward(q, k, v, *mask)


def _forward(q, k, v, causal, window, prefix_pad=0, prefix_len=0):
    """The kernel on CUDA tensors, the plain version on CPU tensors, the
    meter on ``meta`` tensors."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_pad=prefix_pad,
                                   prefix_len=prefix_len)
    if q.device.type == "meta":
        return _build.meta_call(flash_attention, flash_attention_work(
            q, k, causal=causal, window=window, prefix_pad=prefix_pad,
            prefix_len=prefix_len), q, torch.empty_like(q))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    B, S, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = _build.load("flash_attention", _SIGNATURES)
    err = lib.flash_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, T, H, KVH, d, int(bool(causal)), int(window),
        prefix_pad, prefix_len, d ** -0.5, _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention, launch_key(
        q, k, causal=causal, window=window, prefix_pad=prefix_pad,
        prefix_len=prefix_len))
    return out


def flash_attention_vjp(q, k, v, g, *, causal=True, window=0, prefix_pad=0,
                        prefix_len=0):
    """(dq, dk, dv) of attention at ``q, k, v`` against the output
    cotangent ``g``: attention recomputed through the plain version under
    the same mask and differentiated, as the reference's ``_bwd`` does
    with ``attention_ref`` under ``jax.vjp``."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_ref(*qkv, causal=causal, window=window,
                                  prefix_pad=prefix_pad,
                                  prefix_len=prefix_len)
        return torch.autograd.grad(out, qkv, g)


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with the reference's recompute backward;
    ``mask`` is (causal, window, prefix_pad, prefix_len)."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v)
        ctx.mask = mask
        return _forward(q, k, v, *mask)

    @staticmethod
    def backward(ctx, g):
        causal, window, prefix_pad, prefix_len = ctx.mask
        with _build.backward(flash_attention):
            dq, dk, dv = flash_attention_vjp(
                *ctx.saved_tensors, g, causal=causal, window=window,
                prefix_pad=prefix_pad, prefix_len=prefix_len)
        return dq, dk, dv, None
