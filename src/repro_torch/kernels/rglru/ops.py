"""RG-LRU linear-recurrence scan: wrapper of the CUDA kernel.

Replaces ``repro/kernels/rglru/kernel.py::rglru_scan_fwd`` (Pallas
``_rglru_kernel``).  CPU tensors take the plain version (:mod:`.ref`);
CUDA tensors launch ``csrc/rglru.cu`` or raise; ``meta`` tensors (the
dry-run) return an empty output and meter :func:`rglru_scan_work`.  The kernel gives each
block ``CHANNELS`` channels of one batch row and walks the sequence in
tiles of ``TILE`` steps, one segment of ``SEGMENT`` steps a warp; every
length and width runs it.

Gradients (for ``h0 is None``, as the reference's custom VJP in
``repro/kernels/rglru/ops.py``): the recurrence's adjoint is the same
recurrence run backwards in time, so the backward (:func:`rglru_scan_vjp`)
runs this scan again, on reversed inputs: the kernel on CUDA tensors.
The reference differentiates its associative-scan oracle instead; the
gradient is the same up to float32 rounding.
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


def rglru_scan_work(a, h0=None) -> tuple:
    """(bytes, flops) of one scan: a and b read and h written once (and
    h0 read once); a multiply and an add a step and channel."""
    B, S, W = a.shape
    return 3 * a.numel() * 4 + (B * W * 4 if h0 is not None else 0), \
        2 * a.numel()


@_build.counted
def rglru_scan(a, b, h0=None):
    """a, b: [B, S, W] f32 → h: [B, S, W] f32 with h_t = a_t·h_{t-1} + b_t
    and h_{-1} = h0 [B, W] (zeros when None).  Takes a gradient in ``a``
    and ``b`` when ``h0`` is None."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        if h0 is not None:
            raise ValueError("rglru_scan takes a gradient only without h0")
        return _RGLRUScan.apply(a, b)
    return _forward(a, b, h0)


def _forward(a, b, h0=None):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b, h0)
    if a.device.type == "meta":
        return _build.meta_call(rglru_scan, rglru_scan_work(a, h0), a,
                                torch.empty_like(a))
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


def rglru_scan_vjp(a, h, g):
    """(da, db) of h = scan(a, b) at its coefficients ``a`` and output
    ``h`` against the cotangent ``g``.  The adjoint dh obeys dh_t = g_t +
    a_{t+1}·dh_{t+1}: the scan over reversed time of g with the
    coefficients shifted by one step, dh = flip(scan(shift(flip(a)),
    flip(g))).  Then db = dh and da_t = dh_t·h_{t-1}, h_{-1} = 0."""
    ar = torch.flip(a, (1,))
    ar = torch.cat([torch.zeros_like(ar[:, :1]), ar[:, :-1]], dim=1)
    dh = torch.flip(_forward(ar, torch.flip(g.to(a.dtype), (1,))),
                    (1,))
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return dh * h_prev, dh


class _RGLRUScan(torch.autograd.Function):
    """The kernel's forward; the backward is the kernel's reversed scan."""

    @staticmethod
    def forward(ctx, a, b):
        h = _forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        with _build.backward(rglru_scan):
            return rglru_scan_vjp(*ctx.saved_tensors, g)
