"""Shared model building blocks: parameter schema and init, norms, RoPE,
sinusoidal positions.

Parameters are nested dicts of tensors with the reference's tree layout
(``repro/models/common.py``), so :mod:`repro_torch.models.convert` maps a
JAX parameter tree onto them leaf by leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class PSpec:
    shape: tuple
    init: str = "normal"      # normal | zeros | ones | embed
    fan_in_axes: tuple = ()   # dims to treat as fan-in for scaling


def init_param(gen: torch.Generator, spec: PSpec, dtype, device):
    """Same shapes and scales as the reference's ``init_param``; the random
    stream is the generator's (the reference seeds per path from
    ``hash(path)``, which changes per process, so the two cannot agree)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        scale = 0.02
    else:
        fan_in = 1
        for a in spec.fan_in_axes or (0,):
            fan_in *= spec.shape[a]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


def init_tree(gen, schema: dict, dtype, device) -> dict:
    return {k: init_tree(gen, v, dtype, device) if isinstance(v, dict)
            else init_param(gen, v, dtype, device)
            for k, v in schema.items()}


def stack_schema(schema: dict, n: int) -> dict:
    """Prepend a stacked-layer axis to every leaf (the reference's
    ``lax.scan`` layout; the port loops over it in Python)."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, dict):
            out[k] = stack_schema(v, n)
        else:
            out[k] = PSpec((n,) + v.shape, v.init,
                           tuple(a + 1 for a in (v.fan_in_axes or (0,))))
    return out


# ---------------------------------------------------------------------------
# norms


def rmsnorm(x, scale, eps):
    """RMSNorm with the reference's ``1 + scale`` convention (scale inits
    to zeros)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layernorm(x, scale, bias, eps):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def norm_schema(cfg, d=None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": PSpec((d,), "ones"), "bias": PSpec((d,), "zeros")}
    return {"scale": PSpec((d,), "zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# pieces of the recurrent blocks (RG-LRU and SSD)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_conv(x, w, b):
    """Depthwise causal conv, width K: y_t = Σ_k w_k · x_{t-k}.  x [B,S,W]."""
    K = w.shape[0]
    S = x.shape[1]
    y = x * w[K - 1].to(x.dtype)
    for k in range(1, min(K, S + 1)):
        shifted = F.pad(x[:, :S - k], (0, 0, k, 0))
        y = y + shifted * w[K - 1 - k].to(x.dtype)
    return y + b.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (NeoX half-rotation, llama/qwen convention)


def rope_cos_sin(positions, head_dim, theta, dtype):
    """positions: [...] int → cos/sin [..., head_dim/2]."""
    half = head_dim // 2
    freqs = torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    inv = theta ** -freqs
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """x: [B, S, H, D]; cos/sin: [B, S, D/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def sinusoidal_positions(positions, d_model, dtype):
    """Whisper-style sinusoidal embeddings [..., d_model] (sin half, then
    cos half) of int ``positions``, computed in float32 for any length
    and cast to ``dtype``."""
    half = d_model // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
