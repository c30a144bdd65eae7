"""Gated SwiGLU feed-forward block (llama/qwen convention)."""

from __future__ import annotations

import torch.nn.functional as F

from .common import PSpec


def mlp_schema(cfg) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PSpec((D, Fd)),
        "w_up": PSpec((D, Fd)),
        "w_down": PSpec((Fd, D)),
    }


def apply_mlp(cfg, p, x):
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ p["w_down"].to(x.dtype)
