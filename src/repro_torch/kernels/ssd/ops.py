"""Mamba-2 SSD chunk scan: wrapper of the CUDA kernel.

Replaces ``repro/kernels/ssd/kernel.py::ssd_chunk_scan_fwd`` (Pallas
``_ssd_kernel``) behind the model-side contract of
``repro/kernels/ssd/ops.py::ssd_chunked``.  CPU tensors take the plain
version (:mod:`.ref`); CUDA tensors launch ``csrc/ssd.cu`` or raise.

The kernel works on ``xdt = x·dt`` and ``da = dt·A`` in float32, as the
reference wrapper does, but forms them itself as it loads a chunk (each
one rounding, as there); the state goes to the kernel as ``[b, H, N,
P]``.  Unlike it, every sequence length runs the kernel: the
kernel masks a ragged tail itself, where the reference sent it to the
plain path.  The kernel walks the sequence in chunks of its own
(``KERNEL_CHUNK``); the result does not depend on the chunk beyond
rounding, so ``chunk`` only sets the plain version's.  The wrapper
allocates the kernel's scratch: the chunk states, the chunks' total log
decays and the chunks' ``C·Bᵀ``.  Inference only: the reference's
recompute VJP waits for the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import ssd_chunked_ref

KERNEL_CHUNK = 128    # csrc/ssd.cu kQ
MAX_HEADDIM = 64      # csrc/ssd.cu kP
MAX_STATE = 128       # csrc/ssd.cu kN

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"ssd_chunk_scan_fwd": [_P] * 11 + [_I] * 5 + [_P]}


def _check(xh, dt, a_log, B, C, initial_state):
    for name, t in (("xh", xh), ("dt", dt), ("a_log", a_log), ("B", B),
                    ("C", C), ("initial_state", initial_state)):
        if t is None:
            continue
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
    if xh.dim() != 4:
        raise ValueError(f"xh {tuple(xh.shape)} is not [b, S, H, P]")
    b, S, H, P = xh.shape
    if tuple(dt.shape) != (b, S, H) or tuple(a_log.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / a_log {tuple(a_log.shape)}"
                         f" do not fit xh {tuple(xh.shape)}")
    if B.dim() != 3 or tuple(B.shape[:2]) != (b, S) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} are not "
                         f"[{b}, {S}, N]")
    N = B.shape[-1]
    if initial_state is not None and \
            tuple(initial_state.shape) != (b, H, P, N):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                         f"not [{b}, {H}, {P}, {N}]")


def _f32(t):
    return t.to(torch.float32).contiguous()


def launch_key(xh, B, initial_state=None) -> tuple:
    """((field, value), ...) of a launch: its shapes and initial state."""
    b, S, H, P = xh.shape
    return (("B", b), ("S", S), ("H", H), ("P", P), ("N", B.shape[-1]),
            ("h0", initial_state is not None))


@_build.counted
def ssd_chunked(xh, dt, a_log, B, C, *, chunk, initial_state=None):
    """xh [b,S,H,P]; dt [b,S,H] (post-softplus, float32); a_log [H]
    (A = -exp(a_log)); B, C [b,S,N] shared by the heads; initial_state
    [b,H,P,N] float32 or None (zeros).
    → (y [b,S,H,P] float32, final state [b,H,P,N] float32)."""
    _check(xh, dt, a_log, B, C, initial_state)
    if xh.device.type == "cpu":
        return ssd_chunked_ref(xh, dt, a_log, B, C, chunk=chunk,
                               initial_state=initial_state)
    if xh.device.type != "cuda":
        raise ValueError(f"unsupported device {xh.device}")
    b, S, H, P = xh.shape
    N = B.shape[-1]
    if P > MAX_HEADDIM or N > MAX_STATE or P % 4 or N % 4:
        raise ValueError(f"the kernel takes head_dim P <= {MAX_HEADDIM} and "
                         f"state N <= {MAX_STATE}, multiples of 4; got "
                         f"P={P}, N={N}")
    xf, dtf, af = _f32(xh), _f32(dt), _f32(a_log)
    Bf, Cf = _f32(B), _f32(C)
    h0 = None if initial_state is None \
        else _f32(initial_state.transpose(-1, -2))       # → [b,H,N,P]
    y = torch.empty_like(xf)
    hout = torch.empty(b, H, N, P, dtype=torch.float32, device=xh.device)
    nc = -(-S // KERNEL_CHUNK)
    states = torch.empty(b, nc, H, N, P, dtype=torch.float32,
                         device=xh.device)
    tot = torch.empty(b, nc, H, dtype=torch.float32, device=xh.device)
    cb = torch.empty(b, nc, KERNEL_CHUNK, KERNEL_CHUNK, dtype=torch.float32,
                     device=xh.device)
    for name, t in (("xh", xf), ("B", Bf), ("C", Cf), ("y", y),
                    ("h0", h0), ("hout", hout)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    lib = _build.load("ssd", _SIGNATURES)
    err = lib.ssd_chunk_scan_fwd(
        xf.data_ptr(), dtf.data_ptr(), af.data_ptr(), Bf.data_ptr(),
        Cf.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        hout.data_ptr(), states.data_ptr(), tot.data_ptr(), cb.data_ptr(),
        b, S, H, P, N, _build.stream_ptr(xh.device))
    _build.check(err, "ssd_chunk_scan")
    _build.count_launch(ssd_chunked, launch_key(xh, B, initial_state))
    return y, hout.transpose(-1, -2)                      # → [b,H,P,N]
