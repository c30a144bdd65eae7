"""Plain PyTorch version of the RG-LRU scan.

A Hillis-Steele doubling scan over the sequence axis, the structure of
the reference kernel's in-tile scan (``repro/kernels/rglru/kernel.py``):
log2(S) vectorized steps of the combine ``(a_l, b_l)∘(a_r, b_r) =
(a_l·a_r, b_l·a_r + b_r)``, so the kernel's sequential loop is checked
against independently structured math.
"""

from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0=None):
    """a, b: [B, S, W] f32 → h: [B, S, W] f32 with h_t = a_t·h_{t-1} + b_t,
    h_{-1} = h0 [B, W] (zeros if None).  (f64 inputs stay f64, for
    gradient checks.)"""
    acc = torch.promote_types(a.dtype, torch.float32)
    a = a.to(acc)
    b = b.to(acc)
    S = a.shape[1]
    shift = 1
    while shift < S:
        # the combine's identity is (a=1, b=0): shifted-in rows pad so
        a_sh = torch.nn.functional.pad(a[:, :S - shift], (0, 0, shift, 0),
                                       value=1.0)
        b_sh = torch.nn.functional.pad(b[:, :S - shift], (0, 0, shift, 0))
        b = b_sh * a + b
        a = a_sh * a
        shift *= 2
    if h0 is not None:
        b = b + a * h0.to(acc)[:, None, :]
    return b
