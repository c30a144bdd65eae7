"""Feed-forward blocks: gated SwiGLU (llama/qwen convention) and the
non-gated GELU MLP with biases (whisper)."""

from __future__ import annotations

import torch.nn.functional as F

from .common import PSpec


def mlp_schema(cfg, *, gated=True) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    if gated:
        return {
            "w_gate": PSpec((D, Fd)),
            "w_up": PSpec((D, Fd)),
            "w_down": PSpec((Fd, D)),
        }
    return {
        "w_up": PSpec((D, Fd)),
        "b_up": PSpec((Fd,), "zeros"),
        "w_down": PSpec((Fd, D)),
        "b_down": PSpec((D,), "zeros"),
    }


def apply_mlp(cfg, p, x, *, gated=True):
    if gated:
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        return (F.silu(g) * u) @ p["w_down"].to(x.dtype)
    h = x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="none")
    return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)
