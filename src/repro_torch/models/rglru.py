"""RecurrentGemma / Griffin recurrent block: gated linear recurrence
(RG-LRU) with a short causal depthwise conv and a GeLU gate branch
[arXiv:2402.19427].

Counterpart of ``repro/models/rglru.py``.  The full-sequence recurrence
``h_t = a_t·h_{t-1} + √(1−a_t²)·(i_t⊙x_t)`` runs in the hand-written
scan kernel (:mod:`repro_torch.kernels.rglru`), whose wrapper picks the
kernel or its plain version by the tensors' device.  The reference's
numerics are kept: the gates' two W×W products run in float32 even in a
bf16 model, the GeLU is the tanh approximation (``jax.nn.gelu``'s
default) and softplus is ``logaddexp(x, 0)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as lru_ops

from .common import PSpec, causal_conv, softplus

_C = 8.0  # Griffin's recurrence-gate temperature


def rglru_schema(cfg) -> dict:
    D, W = cfg.d_model, cfg.lru_width
    K = cfg.conv_width
    return {
        "w_in": PSpec((D, W)),
        "w_gate_branch": PSpec((D, W)),
        "conv_w": PSpec((K, W), "normal", (0,)),
        "conv_b": PSpec((W,), "zeros"),
        # RG-LRU gates
        "w_a": PSpec((W, W)),
        "b_a": PSpec((W,), "zeros"),
        "w_x": PSpec((W, W)),
        "b_x": PSpec((W,), "zeros"),
        "lambda_p": PSpec((W,), "ones"),
        "w_out": PSpec((W, D)),
    }


def _gates(p, x):
    """x: [..., W] → (a, gated input) in f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"].float())
    log_a = -_C * softplus(p["lambda_p"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i * xf)


def _branches(p, x):
    gate = F.gelu(x @ p["w_gate_branch"].to(x.dtype), approximate="tanh")
    u = x @ p["w_in"].to(x.dtype)
    return gate, u


def apply_rglru(cfg, p, x, *, return_state=False):
    """Full-sequence Griffin recurrent block.  x: [B,S,D] → [B,S,D], and
    with ``return_state`` the decode cache ``{"h": [B,W] f32, "conv":
    [B,K-1,W]}``: the last recurrent state and the conv's input history,
    oldest first.  A prompt shorter than K−1 tokens gets its history
    left-padded with zeros, the causal conv's own zero history, so decode
    continues exactly where ``forward`` would (the reference keeps the
    short history and its engine pads it at the end, which shifts it)."""
    gate, u = _branches(p, x)
    a, bx = _gates(p, causal_conv(u, p["conv_w"], p["conv_b"]))
    h = lru_ops.rglru_scan(a.contiguous(), bx.contiguous())
    y = h.to(x.dtype) * gate
    out = y @ p["w_out"].to(x.dtype)
    if return_state:
        # copies, not views: the state must not keep [B, S, W] alive
        K = p["conv_w"].shape[0]
        hist = F.pad(u[:, -(K - 1):], (0, 0, max(0, K - 1 - u.shape[1]), 0))
        return out, {"h": h[:, -1].clone(), "conv": hist.clone()}
    return out


def init_rglru_cache(cfg, batch, dtype, device):
    W, K = cfg.lru_width, cfg.conv_width
    return {
        "h": torch.zeros((batch, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, K - 1, W), dtype=dtype, device=device),
    }


def decode_rglru(cfg, p, x, cache):
    """One-token step.  x: [B,1,D]; cache {h [B,W] f32, conv [B,K-1,W]},
    updated **in place** (the reference returned a new cache).  Returns
    out [B,1,D]."""
    gate, u = _branches(p, x)                          # [B,1,W]
    hist = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(u.dtype)
    conv_out = torch.einsum("bkw,kw->bw", hist.to(u.dtype), w) \
        + p["conv_b"].to(u.dtype)
    a, bx = _gates(p, conv_out[:, None])
    h = a[:, 0] * cache["h"] + bx[:, 0]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    y = h.to(x.dtype)[:, None] * gate
    return y @ p["w_out"].to(x.dtype)
