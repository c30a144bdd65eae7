"""RG-LRU linear-recurrence scan: wrapper of the CUDA kernel.

Replaces ``repro/kernels/rglru/kernel.py::rglru_scan_fwd`` (Pallas
``_rglru_kernel``).  CPU tensors take the plain version (:mod:`.ref`);
CUDA tensors launch ``csrc/rglru.cu`` or raise.  The kernel gives each
block ``CHANNELS`` channels of one batch row and walks the sequence in
tiles of ``TILE`` steps, one segment of ``SEGMENT`` steps a warp; every
length and width runs it.  Inference only: the reference's recompute VJP
waits for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import rglru_scan_ref

CHANNELS = 32     # csrc/rglru.cu kChannels
TILE = 128        # csrc/rglru.cu kTile
SEGMENT = 16      # csrc/rglru.cu kSeg = kTile / kWarps

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rglru_scan_fwd": [_P, _P, _P, _P, _I, _I, _I, _P]}


def _check(a, b, h0):
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a/b must be float32, got {a.dtype}/{b.dtype}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"shapes a {tuple(a.shape)} b {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if h0 is not None:
        if h0.device != a.device or h0.dtype != torch.float32:
            raise TypeError("h0 must be float32 on a's device")
        if h0.shape != (a.shape[0], a.shape[2]):
            raise ValueError(f"h0 {tuple(h0.shape)} is not [B, W]")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_key(a, h0=None) -> tuple:
    """((field, value), ...) of a launch: its shape and initial state."""
    B, S, W = a.shape
    return (("B", B), ("S", S), ("W", W), ("h0", h0 is not None))


@_build.counted
def rglru_scan(a, b, h0=None):
    """a, b: [B, S, W] f32 → h: [B, S, W] f32 with h_t = a_t·h_{t-1} + b_t
    and h_{-1} = h0 [B, W] (zeros when None)."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, b, h0)
    B, S, W = a.shape
    out = torch.empty_like(a)
    lib = _build.load("rglru", _SIGNATURES)
    err = lib.rglru_scan_fwd(
        a.data_ptr(), b.data_ptr(), h0.data_ptr() if h0 is not None else None,
        out.data_ptr(), B, S, W, _build.stream_ptr(a.device))
    _build.check(err, "rglru_scan")
    _build.count_launch(rglru_scan, launch_key(a, h0))
    return out
