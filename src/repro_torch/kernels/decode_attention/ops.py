"""Decode attention over a contiguous or ring KV cache, dense and int8:
wrappers of the CUDA kernel.

Replace ``repro/kernels/decode_attention/kernel.py::decode_attention_fwd``
and ``::decode_attention_int8_fwd`` (Pallas ``_dec_kernel`` and
``_dec_int8_kernel``).  CPU tensors take the plain versions (:mod:`.ref`);
CUDA tensors launch ``csrc/decode_attention.cu`` or raise.

The ``*_partial`` wrappers stop before the merge and return the split-K
partials (``acc`` [B,H,n,d], ``ml`` [B,H,n,2]: the max scaled score in
natural-log units and the sum of exponentials); :func:`decode_combine`
merges any stack of such partials along n, e.g. those of the shards of a
cache split by sequence (:func:`repro_torch.models.attention.
decode_attention_seq_split`).

On ``meta`` tensors (the dry-run) a wrapper runs nothing: it returns
empty outputs of the kernel's shapes and hands its ``*_work`` to the
meter, counting every slot of the cache as attended.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import (
    decode_attention_int8_ref,
    decode_attention_ref,
    decode_combine_ref,
    decode_partial_int8_ref,
    decode_partial_ref,
)

MAX_GROUP = 16    # q heads per kv head: the 16 rows of the mma A tile
MAX_HEAD_DIM = 256
TILE = 32         # f32/int8 kernel: cache positions per tile (one a lane)
MMA_TILE = 64     # bf16-q kernels: cache positions per tile (16 a warp)
MMA_K = 16        # bf16-q kernels' mma k-step: d must be a multiple
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# B, C, H, KVH, KVS, d, chunk, n_split, scale, stream
_TAIL = [_I] * 8 + [_F, _P]
_SIGNATURES = {
    "decode_attention_fwd": [_I] + [_P] * 7 + _TAIL,
    "decode_attention_int8_fwd": [_I] + [_P] * 9 + _TAIL,
    "decode_attention_partial_fwd": [_I] + [_P] * 6 + _TAIL,
    "decode_attention_int8_partial_fwd": [_I] + [_P] * 8 + _TAIL,
    # dtype, part_acc, part_ml, out, B, H, d, n_split, stream
    "decode_combine_fwd": [_I] + [_P] * 3 + [_I] * 4 + [_P],
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
    """Raises unless the kernel takes these inputs → the heads a cache row
    holds (KVS: more than ``k.shape[2]`` where the cache and its scales
    are views narrowed to a run of their KV heads)."""
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
    for name, t in (("q", q), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kvs = _build.head_stride(k, 2, "k")
    if _build.head_stride(v, 2, "v") != kvs or v.stride() != k.stride() \
            or any(_build.head_stride(s, 2, "scale") != kvs
                   for s in scales):
        raise ValueError("k, v and their scales must hold as many heads "
                         "a row")
    if mma and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start 16-byte aligned (the bf16 "
                         "kernel copies rows 16 bytes at a time)")
    return kvs


def _uses_mma(q_dtype, kv_dtype):
    """bf16 q runs the tensor-core kernels (dense bf16 or int8 K/V); f32 q,
    the check path, the CUDA cores."""
    return q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16,
                                                      torch.int8)


def decode_attention_work(q, k, n_valid, *, int8=False,
                          n_split=0) -> tuple:
    """(bytes, flops) of one call over ``n_valid`` attended slots: q read
    once (and the output written once, unless this is a partial entry,
    which writes ``n_split`` partials of d + 2 floats a head instead),
    each attended K and V row read once (int8: a byte an element plus its
    f32 scale), the valid mask read once; 4·d multiply-adds a (head,
    slot) pair."""
    B, _, H, d = q.shape
    C, KVH = k.shape[1], k.shape[2]
    es = q.element_size()
    kv_es = 1 + 4 / d if int8 else es
    out = B * H * n_split * (d + 2) * 4 if n_split else q.numel() * es
    return (q.numel() * es + out + 2 * n_valid * KVH * d * kv_es + B * C,
            4 * n_valid * H * d)


def decode_combine_work(acc, dtype) -> tuple:
    """(bytes, flops) of one combine: the partials read once, the output
    written once; three operations a partial element."""
    B, H, n, d = acc.shape
    es = torch.tensor([], dtype=dtype).element_size()
    return acc.numel() * 4 + B * H * n * 2 * 4 + B * H * d * es, \
        3 * acc.numel()


def _meta(wrapper, q, k, *, int8=False, partial=False):
    """A call on ``meta`` tensors: empty outputs, every slot attended."""
    B, _, H, d = q.shape
    n_valid = B * k.shape[1]
    if partial:
        outs = (torch.empty((B, H, 1, d), dtype=torch.float32,
                            device="meta"),
                torch.empty((B, H, 1, 2), dtype=torch.float32,
                            device="meta"))
    else:
        outs = torch.empty_like(q)
    return _build.meta_call(wrapper, decode_attention_work(
        q, k, n_valid, int8=int8, n_split=1 if partial else 0), q, outs)


def launch_plan(q, k) -> tuple:
    """(chunk, n_split) of a launch over cache ``k`` on q's device: the
    plan the kernel runs on a card (and the plain partial's at its
    check); on the CPU (and on ``meta``) the plain version's one chunk."""
    B, _, H, d = q.shape
    C, KVH = k.shape[1], k.shape[2]
    if q.device.type in ("cpu", "meta"):
        return C, 1
    plan = {} if _uses_mma(q.dtype, k.dtype) else dict(tile=TILE,
                                                      blocks_per_sm=2)
    return split_plan(B, KVH, C, torch.cuda.get_device_properties(
        q.device).multi_processor_count, **plan)


def _launch(fn, q, k, kvs, tensors, *, partial=False):
    """Run entry ``fn`` over a cache whose rows hold ``kvs`` heads: → out
    [B,1,H,d], or with ``partial`` the partials (acc [B,H,n,d], ml
    [B,H,n,2])."""
    B, _, H, d = q.shape
    C, KVH = k.shape[1], k.shape[2]
    chunk, n_split = launch_plan(q, k)
    part_acc = torch.empty((B, H, n_split, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    out = None if partial else torch.empty_like(q)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = getattr(lib, fn)(
        _DTYPES[q.dtype], *(t.data_ptr() for t in tensors),
        part_acc.data_ptr(), part_ml.data_ptr(),
        *(() if partial else (out.data_ptr(),)), B, C, H,
        KVH, kvs, d, chunk, n_split, d ** -0.5, _build.stream_ptr(q.device))
    _build.check(err, fn)
    return (part_acc, part_ml) if partial else out


def launch_key(q, k) -> tuple:
    """((field, value), ...) of a launch: its dtype and shapes."""
    B, _, H, d = q.shape
    return (("dtype", _build.dtype_name(q.dtype)), ("B", B),
            ("C", k.shape[1]), ("H", H), ("KVH", k.shape[2]), ("d", d))


@_build.counted
def decode_attention(q, k, v, valid):
    """q: [B,1,H,d]; k,v: [B,C,KVH,d] in q's dtype, contiguous or views
    of a cache narrowed to KVH of its heads (read in place); valid: [B,C]
    bool → [B,1,H,d].  Position j of row b attends iff ``valid[b, j]``."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid)
    if q.device.type == "meta":
        return _meta(decode_attention, q, k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kvs = _check(q, k, v, valid, q.dtype)
    out = _launch("decode_attention_fwd", q, k, kvs, (q, k, v, valid))
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
    if q.device.type == "meta":
        return _meta(decode_attention_int8, q, k_q, int8=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kvs = _check(q, k_q, v_q, valid, torch.int8, (k_scale, v_scale))
    out = _launch("decode_attention_int8_fwd", q, k_q, kvs,
                  (q, k_q, v_q, k_scale, v_scale, valid))
    _build.count_launch(decode_attention_int8, launch_key(q, k_q))
    return out


@_build.counted
def decode_attention_partial(q, k, v, valid):
    """:func:`decode_attention` without its merge → (acc [B,H,n,d] f32,
    ml [B,H,n,2] f32): one partial per chunk of the cache (the kernel's
    split plan; one chunk on the CPU).  Merge with :func:`decode_combine`,
    alone or stacked along n with other caches' partials."""
    if q.device.type == "cpu":
        return decode_partial_ref(q, k, v, valid)
    if q.device.type == "meta":
        return _meta(decode_attention_partial, q, k, partial=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kvs = _check(q, k, v, valid, q.dtype)
    out = _launch("decode_attention_partial_fwd", q, k, kvs,
                  (q, k, v, valid), partial=True)
    _build.count_launch(decode_attention_partial, launch_key(q, k))
    return out


@_build.counted
def decode_attention_int8_partial(q, k_q, v_q, k_scale, v_scale, valid):
    """:func:`decode_attention_int8` without its merge; as
    :func:`decode_attention_partial`."""
    if q.device.type == "cpu":
        return decode_partial_int8_ref(q, k_q, v_q, k_scale, v_scale, valid)
    if q.device.type == "meta":
        return _meta(decode_attention_int8_partial, q, k_q, int8=True,
                     partial=True)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kvs = _check(q, k_q, v_q, valid, torch.int8, (k_scale, v_scale))
    out = _launch("decode_attention_int8_partial_fwd", q, k_q, kvs,
                  (q, k_q, v_q, k_scale, v_scale, valid), partial=True)
    _build.count_launch(decode_attention_int8_partial, launch_key(q, k_q))
    return out


def combine_key(acc, dtype) -> tuple:
    B, H, n, d = acc.shape
    return (("dtype", _build.dtype_name(dtype)), ("B", B), ("H", H),
            ("n_split", n), ("d", d))


@_build.counted
def decode_combine(acc, ml, dtype):
    """Merge partials acc [B,H,n,d] and ml [B,H,n,2] (f32, contiguous)
    over n → out [B,1,H,d] in ``dtype`` (float32 or bfloat16)."""
    if acc.device.type == "cpu":
        return decode_combine_ref(acc, ml, dtype)
    if acc.device.type == "meta":
        B, H, _, d = acc.shape
        return _build.meta_call(
            decode_combine, decode_combine_work(acc, dtype), acc,
            torch.empty((B, 1, H, d), dtype=dtype, device="meta"))
    if acc.device.type != "cuda":
        raise ValueError(f"unsupported device {acc.device}")
    B, H, n, d = acc.shape
    if dtype not in _DTYPES or acc.dtype != torch.float32 \
            or ml.dtype != torch.float32 or ml.shape != (B, H, n, 2) \
            or ml.device != acc.device:
        raise ValueError(f"partials {acc.dtype} {tuple(acc.shape)} / "
                         f"{ml.dtype} {tuple(ml.shape)} to {dtype}")
    if not (acc.is_contiguous() and ml.is_contiguous()):
        raise ValueError("partials must be contiguous")
    out = torch.empty((B, 1, H, d), dtype=dtype, device=acc.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    err = lib.decode_combine_fwd(_DTYPES[dtype], acc.data_ptr(),
                                 ml.data_ptr(), out.data_ptr(), B, H, d, n,
                                 _build.stream_ptr(acc.device))
    _build.check(err, "decode_combine_fwd")
    _build.count_launch(decode_combine, combine_key(acc, dtype))
    return out
