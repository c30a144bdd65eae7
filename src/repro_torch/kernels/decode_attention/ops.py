"""Decode attention over a contiguous or ring KV cache, dense and int8:
wrappers of the CUDA kernel.

Replace ``repro/kernels/decode_attention/kernel.py::decode_attention_fwd``
and ``::decode_attention_int8_fwd`` (Pallas ``_dec_kernel`` and
``_dec_int8_kernel``).  CPU tensors take the plain versions (:mod:`.ref`);
CUDA tensors launch ``csrc/decode_attention.cu`` or raise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import decode_attention_int8_ref, decode_attention_ref

MAX_GROUP = 16    # q heads per kv head: the 16 rows of the mma A tile
MAX_HEAD_DIM = 256
TILE = 32         # f32/int8 kernel: cache positions per tile (one a lane)
MMA_TILE = 64     # bf16-q kernels: cache positions per tile (16 a warp)
MMA_K = 16        # bf16-q kernels' mma k-step: d must be a multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TAIL = [_I] * 7 + [_F, _P]   # B, C, H, KVH, d, chunk, n_split, scale, stream
_SIGNATURES = {
    "decode_attention_fwd": [_I] + [_P] * 7 + _TAIL,
    "decode_attention_int8_fwd": [_I] + [_P] * 9 + _TAIL,
}


def split_plan(B, KVH, C, num_sms, *, tile=MMA_TILE, blocks_per_sm=1):
    """(chunk, n_split): the cache length is cut into ``n_split`` chunks
    of ``chunk`` positions (a multiple of ``tile``), one block each per
    (b, kv head), aiming at ``blocks_per_sm`` blocks per SM: one for the
    bf16-q tensor-core kernels (whose double-buffered 64-position tiles
    fill an SM's shared memory at d = 256), two for the f32-q kernel."""
    n = max(1, min(-(-blocks_per_sm * num_sms // (B * KVH)), -(-C // tile)))
    chunk = -(-(-(-C // n)) // tile) * tile
    return chunk, -(-C // chunk)


def _check(q, k, v, valid, kv_dtype, scales=()):
    dev = q.device
    for name, t in (("k", k), ("v", v), ("valid", valid),
                    *(("scale", s) for s in scales)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"k/v must be {kv_dtype}, got {k.dtype}/{v.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    B, one, H, d = q.shape
    Bk, C, KVH, dk = k.shape
    if one != 1 or Bk != B or dk != d or v.shape != k.shape \
            or valid.shape != (B, C):
        raise ValueError(f"shapes q {tuple(q.shape)} k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} valid {tuple(valid.shape)}")
    for s in scales:
        if s.dtype != torch.float32 or s.shape != (B, C, KVH):
            raise ValueError(f"scales must be float32 [B, C, KVH], got "
                             f"{s.dtype} {tuple(s.shape)}")
    if H % KVH or H // KVH > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"H={H}, KVH={KVH}, d={d}: the kernel takes "
                         f"H/KVH <= {MAX_GROUP} and d <= {MAX_HEAD_DIM}")
    mma = _uses_mma(q.dtype, kv_dtype)
    if mma and d % MMA_K:
        raise ValueError(f"d={d}: the bfloat16 kernel takes d a multiple "
                         f"of {MMA_K}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid),
                    *(("scale", s) for s in scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mma and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned (the bf16 "
                         "kernel copies rows 16 bytes at a time)")


def _uses_mma(q_dtype, kv_dtype):
    """bf16 q runs the tensor-core kernels (dense bf16 or int8 K/V); f32 q,
    the check path, the CUDA cores."""
    return q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16,
                                                      torch.int8)


def _launch(fn, q, k, tensors):
    B, _, H, d = q.shape
    C, KVH = k.shape[1], k.shape[2]
    plan = {} if _uses_mma(q.dtype, k.dtype) else dict(tile=TILE,
                                                      blocks_per_sm=2)
    chunk, n_split = split_plan(
        B, KVH, C, torch.cuda.get_device_properties(q.device)
        .multi_processor_count, **plan)
    out = torch.empty_like(q)
    part_acc = torch.empty(B * H * n_split * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                          device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = getattr(lib, fn)(
        _DTYPES[q.dtype], *(t.data_ptr() for t in tensors),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, C, H,
        KVH, d, chunk, n_split, d ** -0.5, _build.stream_ptr(q.device))
    _build.check(err, fn)
    return out


def launch_key(q, k) -> tuple:
    """((field, value), ...) of a launch: its dtype and shapes."""
    B, _, H, d = q.shape
    return (("dtype", _build.dtype_name(q.dtype)), ("B", B),
            ("C", k.shape[1]), ("H", H), ("KVH", k.shape[2]), ("d", d))


@_build.counted
def decode_attention(q, k, v, valid):
    """q: [B,1,H,d]; k,v: [B,C,KVH,d] in q's dtype; valid: [B,C] bool →
    [B,1,H,d].  Position j of row b attends iff ``valid[b, j]``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v, valid, q.dtype)
    out = _launch("decode_attention_fwd", q, k, (q, k, v, valid))
    _build.count_launch(decode_attention, launch_key(q, k))
    return out


@_build.counted
def decode_attention_int8(q, k_q, v_q, k_scale, v_scale, valid):
    """The same over int8 K/V [B,C,KVH,d] with f32 scales [B,C,KVH] per
    (position, head): the cache is read as int8 (bf16 q: converted to bf16
    in shared memory, the scales applied to the scores and probabilities;
    f32 q: dequantized in registers)."""
    if q.device.type == "cpu":
        return decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale,
                                         valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_q, v_q, valid, torch.int8, (k_scale, v_scale))
    out = _launch("decode_attention_int8_fwd", q, k_q,
                  (q, k_q, v_q, k_scale, v_scale, valid))
    _build.count_launch(decode_attention_int8, launch_key(q, k_q))
    return out
