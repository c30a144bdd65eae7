"""Mamba-2 block with the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

Counterpart of ``repro/models/ssd.py``.  Prefill runs the chunk scan in
the hand-written kernel (:mod:`repro_torch.kernels.ssd`), whose wrapper
picks the kernel or its plain version by the tensors' device; decode is
the O(1)-state recurrent step in plain tensor code (the reference has no
kernel there either).  The reference's numerics are kept: the ``D`` skip
in float32, ``y`` cast to the activation dtype before the ``silu(z)``
gate, the gated RMSNorm in float32 with eps 1e-6 and ``1 + norm_scale``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops

from .common import PSpec, causal_conv, rmsnorm, softplus

_NORM_EPS = 1e-6


def ssd_schema(cfg) -> dict:
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.conv_width
    return {
        # fused input projection → [z (DI), x (DI), B (N), C (N), dt (H)]
        "w_in": PSpec((D, 2 * DI + 2 * N + H), axes=("embed", "inner_fused")),
        "conv_w": PSpec((K, DI + 2 * N), "normal", (0,), ("conv", "inner")),
        "conv_b": PSpec((DI + 2 * N,), "zeros", axes=("inner",)),
        "a_log": PSpec((H,), "ones", axes=("ssm_heads",)),
        "dt_bias": PSpec((H,), "zeros", axes=("ssm_heads",)),
        "d_skip": PSpec((H,), "ones", axes=("ssm_heads",)),
        "norm_scale": PSpec((DI,), "zeros", axes=("inner",)),
        "w_out": PSpec((DI, D), axes=("inner", "embed")),
    }


def _split_proj(cfg, proj):
    """→ (z, conv input [x, B, C], dt) of the fused projection."""
    DI, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :DI], proj[..., DI:2 * DI + 2 * N], \
        proj[..., 2 * DI + 2 * N:]


def _split_conv(cfg, conv_out):
    DI, N = cfg.d_inner, cfg.ssm_state
    return conv_out[..., :DI], conv_out[..., DI:DI + N], \
        conv_out[..., DI + N:]


def _gate_norm_out(p, y, z):
    """y [..., DI] f32 → gated RMSNorm (mamba2's norm-before-out) → w_out."""
    y = y.to(z.dtype) * F.silu(z)
    y = rmsnorm(y, p["norm_scale"], _NORM_EPS)
    return y @ p["w_out"].to(z.dtype)


def apply_ssd(cfg, p, x, *, return_state=False):
    """Full-sequence Mamba-2 block.  x: [B,S,D] → [B,S,D], and with
    ``return_state`` the decode cache ``{"ssm": [B,H,P,N] f32, "conv":
    [B,K-1,DI+2N]}``: the final SSM state and the conv's pre-activation
    input history, oldest first.  A prompt shorter than K−1 tokens gets
    its history left-padded with zeros, the causal conv's own zero history
    (the reference keeps the short history and its engine pads it at the
    end, which shifts it)."""
    b, S, _ = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    proj = x @ p["w_in"].to(x.dtype)
    z, conv_in, dt = _split_proj(cfg, proj)
    xi, B_, C_ = _split_conv(cfg, F.silu(causal_conv(conv_in, p["conv_w"],
                                                      p["conv_b"])))
    dt = softplus(dt.float() + p["dt_bias"].float())
    xh = xi.reshape(b, S, H, P)
    y, state = ssd_ops.ssd_chunked(xh, dt, p["a_log"], B_, C_,
                                   chunk=cfg.ssm_chunk)
    y = y + xh.float() * p["d_skip"].float()[None, None, :, None]
    out = _gate_norm_out(p, y.reshape(b, S, cfg.d_inner), z)
    if return_state:
        # a copy, not a view: the history must not keep [B, S, ...] alive
        K = p["conv_w"].shape[0]
        hist = F.pad(conv_in[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0))
        return out, {"ssm": state, "conv": hist.clone()}
    return out


def init_ssd_cache(cfg, batch, dtype, device):
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    K = cfg.conv_width
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, K - 1, cfg.d_inner + 2 * N), dtype=dtype,
                            device=device),
    }


def decode_ssd(cfg, p, x, cache):
    """One-token Mamba-2 step.  x: [B,1,D]; cache {ssm [B,H,P,N] f32,
    conv [B,K-1,DI+2N]}, updated **in place** (the reference returned a
    new cache).  Returns out [B,1,D]."""
    b = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    proj = x @ p["w_in"].to(x.dtype)
    z, pre, dt = _split_proj(cfg, proj)                 # pre [B,1,DI+2N]
    hist = torch.cat([cache["conv"], pre.to(cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist.to(x.dtype),
                            p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    xi, B_, C_ = _split_conv(cfg, F.silu(conv_out))
    dt1 = softplus(dt[:, 0].float() + p["dt_bias"].float())    # [B,H]
    dA = torch.exp(dt1 * -torch.exp(p["a_log"].float()))       # [B,H]
    xh = xi.reshape(b, H, P).float()
    h = cache["ssm"]
    h.mul_(dA[..., None, None]).add_(
        (xh * dt1[..., None])[..., None] * B_.float()[:, None, None, :])
    y = (h @ C_.float()[:, None, :, None])[..., 0]               # [B,H,P]
    y = y + xh * p["d_skip"].float()[None, :, None]
    cache["conv"].copy_(hist[:, 1:])
    return _gate_norm_out(p, y.reshape(b, 1, cfg.d_inner), z)
