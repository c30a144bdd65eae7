"""Paged decode attention: wrapper of the CUDA kernel.

Replaces ``repro/kernels/paged_attention/kernel.py::paged_decode_attention_fwd``
(Pallas ``_paged_kernel``).  CPU tensors take the plain version
(:mod:`.ref`); CUDA tensors launch ``csrc/paged_attention.cu`` or raise:
bf16 the tensor-core kernel, split over fixed chunks of the page table's
reach, then the combine; f32 (the check path) the CUDA-core kernel.
``meta`` tensors (the dry-run) return an empty output and meter
:func:`paged_decode_attention_work`, every table entry's positions
attended.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import paged_decode_attention_ref

# q heads per kv head: the f32 kernel holds them in registers, the bf16
# kernel as the 16 rows of its mma A tile
MAX_GROUP = {torch.float32: 8, torch.bfloat16: 16}
MAX_HEAD_DIM = 256
MMA_TILE = 64     # bf16 kernel: positions per K/V tile (16 a warp)
MMA_K = 16        # bf16 kernel's mma k-step: d must be a multiple
CHUNK = 128       # bf16 kernel: positions per split (csrc kChunk)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"paged_decode_attention_fwd":
               [_I] + [_P] * 8 + [_I] * 10 + [_F, _P]}


def split_plan(N, ps):
    """n_split of the bf16 kernel: the page table's reach of ``N * ps``
    positions in splits of CHUNK positions.  It depends on the table's
    width alone, never on the lengths (which stay on the device): a split
    that misses a sequence's kept positions exits at once and the combine
    skips it."""
    return -(-N * ps // CHUNK)


def _check(q, k_pages, v_pages, page_table, lengths):
    """Raises unless the kernel takes these inputs → the heads a pool row
    holds (KVS: more than ``k_pages.shape[2]`` where the pools are views
    narrowed to a run of their KV heads)."""
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("k_pages/v_pages must have q's dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    B, one, H, d = q.shape
    P, ps, KVH, dk = k_pages.shape
    if one != 1 or dk != d or v_pages.shape != k_pages.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k/v "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {B}")
    max_g = MAX_GROUP[q.dtype]
    if H % KVH or H // KVH > max_g or d > MAX_HEAD_DIM:
        raise ValueError(f"H={H}, KVH={KVH}, d={d}: the kernel takes "
                         f"H/KVH <= {max_g} and d <= {MAX_HEAD_DIM}")
    mma = q.dtype == torch.bfloat16
    if mma and d % MMA_K:
        raise ValueError(f"d={d}: the bfloat16 kernel takes d a multiple "
                         f"of {MMA_K}")
    for name, t in (("q", q), ("page_table", page_table),
                    ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    kvs = _build.head_stride(k_pages, 2, "k_pages")
    if _build.head_stride(v_pages, 2, "v_pages") != kvs \
            or v_pages.stride() != k_pages.stride():
        raise ValueError("k_pages and v_pages must have one layout")
    if mma and any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q, k_pages and v_pages must start 16-byte aligned "
                         "(the bf16 kernel copies rows 16 bytes at a time)")
    return kvs


def launch_key(q, k_pages, page_table, *, window=0) -> tuple:
    """((field, value), ...) of a launch: its dtype, shapes and window
    (the pool's size and the lengths left out)."""
    B, _, H, d = q.shape
    return (("dtype", _build.dtype_name(q.dtype)), ("B", B), ("H", H),
            ("KVH", k_pages.shape[2]), ("d", d), ("ps", k_pages.shape[1]),
            ("N", page_table.shape[1]), ("window", int(window)))


def paged_decode_attention_work(q, k_pages, page_table, *, tokens,
                                kv_rows) -> tuple:
    """(bytes, flops) of one call: q read and the output written once,
    the ``kv_rows`` pool rows the tables reach read once for K and for V,
    the table and the lengths read once; 4·d multiply-adds a (head,
    attended position) pair over ``tokens`` attended positions."""
    B, _, H, d = q.shape
    KVH = k_pages.shape[2]
    es = q.element_size()
    return (2 * q.numel() * es + 2 * kv_rows * KVH * d * es
            + page_table.numel() * 4 + B * 4, 4 * tokens * H * d)


@_build.counted
def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           window=0):
    """q: [B,1,H,d]; k_pages,v_pages: [P,ps,KVH,d], contiguous or views
    of a pool narrowed to KVH of its heads (read in place); page_table:
    [B,N] int32; lengths: [B] int32 → [B,1,H,d].  Keys at positions
    ``[max(0, len - window), len)`` attend (all of ``[0, len)`` without a
    window)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          lengths, window=window)
    if q.device.type == "meta":    # every table entry's positions attended
        n = page_table.numel() * k_pages.shape[1]
        return _build.meta_call(paged_decode_attention,
                                paged_decode_attention_work(
                                    q, k_pages, page_table, tokens=n,
                                    kv_rows=n), q, torch.empty_like(q))
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kvs = _check(q, k_pages, v_pages, page_table, lengths)
    B, _, H, d = q.shape
    P, ps, KVH, _ = k_pages.shape
    N = page_table.shape[1]
    out = torch.empty_like(q)
    # the CUDA-core f32 kernel writes no partials
    n_split = split_plan(N, ps) if q.dtype == torch.bfloat16 else 0
    part_acc = torch.empty(B * H * n_split * d, dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                          device=q.device)
    lib = _build.load("paged_attention", _SIGNATURES)
    err = lib.paged_decode_attention_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), lengths.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), B, H, KVH,
        kvs, d, ps, N, P, int(window), n_split, d ** -0.5,
        _build.stream_ptr(q.device))
    _build.check(err, "paged_decode_attention")
    _build.count_launch(paged_decode_attention,
                        launch_key(q, k_pages, page_table, window=window))
    return out
