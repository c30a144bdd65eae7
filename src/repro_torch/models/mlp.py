"""Feed-forward blocks: gated SwiGLU (llama/qwen convention) and the
non-gated GELU MLP with biases (whisper), and their tensor-parallel form
(:func:`apply_mlp_tp`)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.sharding.placement import broadcast, reduce_sum

from .common import PSpec


def mlp_schema(cfg, *, gated=True) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    if gated:
        return {
            "w_gate": PSpec((D, Fd), axes=("embed", "ffn")),
            "w_up": PSpec((D, Fd), axes=("embed", "ffn")),
            "w_down": PSpec((Fd, D), axes=("ffn", "embed")),
        }
    return {
        "w_up": PSpec((D, Fd), axes=("embed", "ffn")),
        "b_up": PSpec((Fd,), "zeros", axes=("ffn",)),
        "w_down": PSpec((Fd, D), axes=("ffn", "embed")),
        "b_down": PSpec((D,), "zeros", axes=("embed",)),
    }


def apply_mlp(cfg, p, x, *, gated=True):
    if gated:
        g = x @ p["w_gate"].to(x.dtype)
        u = x @ p["w_up"].to(x.dtype)
        return (F.silu(g) * u) @ p["w_down"].to(x.dtype)
    h = x @ p["w_up"].to(x.dtype) + p["b_up"].to(x.dtype)
    h = F.gelu(h, approximate="none")
    return h @ p["w_down"].to(x.dtype) + p["b_down"].to(x.dtype)


def apply_mlp_tp(cfg, ps, x, devices, *, row_parallel, gated=True):
    """The MLP over tensor-parallel shards: ``ps[r]`` is shard r's
    parameters, on ``devices[r]``; ``x`` is replicated (one tensor, on
    shard 0's device).  With ``row_parallel`` (the hidden dim sharded)
    each shard's down projection is a partial sum that one
    :func:`reduce_sum` adds up; otherwise every shard holds the whole
    MLP and shard 0's result is the answer.  The output bias is added
    once, after the sum.  → the output on shard 0's device."""
    xs = broadcast(x, devices)
    parts = []
    for p, xr in zip(ps, xs):
        if gated:
            h = F.silu(xr @ p["w_gate"].to(xr.dtype)) \
                * (xr @ p["w_up"].to(xr.dtype))
        else:
            h = F.gelu(xr @ p["w_up"].to(xr.dtype) + p["b_up"].to(xr.dtype),
                       approximate="none")
        parts.append(h @ p["w_down"].to(xr.dtype))
        if not row_parallel:
            break
    out = reduce_sum(parts)[0] if row_parallel else parts[0]
    if not gated:
        out = out + ps[0]["b_down"].to(out.dtype)
    return out
