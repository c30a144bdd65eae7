"""Flash attention forward with an optional padded prefix: wrapper of the
CUDA kernel.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_fwd``
(Pallas ``_fa_kernel``) and extends it with the serving engine's prefix
mode, so prefix-aware prefill runs in this kernel too.  CPU tensors take
the plain version (:mod:`.ref`); CUDA tensors launch
``csrc/flash_attention.cu`` or raise.  Inference only: the custom VJP of
the reference waits for the training slice.
"""

from __future__ import annotations

import ctypes

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


@_build.counted
def flash_attention(q, k, v, *, causal=True, window=0, prefix_pad=0,
                    prefix_len=0):
    """q: [B,S,H,d]; k,v: [B,T,KVH,d] → [B,S,H,d].

    Keys are the ``prefix_pad`` rows of a padded prefix followed by the
    queries' own rows.  Query i keeps key j iff j < prefix_len, or
    j >= prefix_pad and j - prefix_pad <= i (when causal) and
    j - prefix_pad > i - window (when window > 0).  ``prefix_pad`` and
    ``prefix_len`` are host ints (the engine knows them); with both 0
    this is the reference kernel's causal/window attention."""
    prefix_pad, prefix_len = int(prefix_pad), int(prefix_len)
    if not 0 <= prefix_len <= prefix_pad <= k.shape[1]:
        raise ValueError(f"need 0 <= prefix_len ({prefix_len}) <= prefix_pad "
                         f"({prefix_pad}) <= T ({k.shape[1]})")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   prefix_pad=prefix_pad,
                                   prefix_len=prefix_len)
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
