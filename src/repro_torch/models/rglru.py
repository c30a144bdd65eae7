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

Under tensor parallelism (:func:`apply_rglru_tp`, :func:`decode_rglru_tp`)
each shard holds the serving rules' slices: the ``lru`` columns of
``w_in``, ``w_gate_branch``, the conv and the per-channel vectors, the
rows of ``w_a`` and ``w_x`` (their contraction dim) and of ``w_out``.
Each gate is then the :func:`reduce_sum` of the shards' float32 partial
products, of which a shard keeps its own columns; the scan runs at
W/tp, and the output projection is a partial sum.  Summing the
contraction in pieces changes its order: the gates agree with the
one-device block to float32 rounding.  A width the shard count does not
divide is replicated (every shard's leaves are whole): each shard runs
the one-device block over the whole width on its copy of the input and
keeps the whole state, and shard 0's output is the block's.  The copies
stay bit-equal, since every shard runs the same kernels on the same
input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru import ops as lru_ops
from repro_torch.sharding.placement import broadcast, reduce_sum

from .common import PSpec, causal_conv, softplus

_C = 8.0  # Griffin's recurrence-gate temperature


def rglru_schema(cfg) -> dict:
    D, W = cfg.d_model, cfg.lru_width
    K = cfg.conv_width
    return {
        "w_in": PSpec((D, W), axes=("embed", "lru")),
        "w_gate_branch": PSpec((D, W), axes=("embed", "lru")),
        "conv_w": PSpec((K, W), "normal", (0,), ("conv", "lru")),
        "conv_b": PSpec((W,), "zeros", axes=("lru",)),
        # RG-LRU gates
        "w_a": PSpec((W, W), axes=("lru", "lru_in")),
        "b_a": PSpec((W,), "zeros", axes=("lru",)),
        "w_x": PSpec((W, W), axes=("lru", "lru_in")),
        "b_x": PSpec((W,), "zeros", axes=("lru",)),
        "lambda_p": PSpec((W,), "ones", axes=("lru",)),
        "w_out": PSpec((W, D), axes=("lru", "embed")),
    }


def _gates(p, x):
    """x: [..., W] → (a, gated input) in f32."""
    xf = x.float()
    return _gate_values(p, xf, xf @ p["w_a"].float(),
                        xf @ p["w_x"].float())


def _gate_values(p, xf, a_logits, x_logits):
    """(a, gated input) from the gates' products (before their biases)."""
    r = torch.sigmoid(a_logits + p["b_a"].float())
    i = torch.sigmoid(x_logits + p["b_x"].float())
    log_a = -_C * softplus(p["lambda_p"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, beta * (i * xf)


def _gates_tp(ps, convs):
    """:func:`_gates` over shards: ``convs[r]`` [..., W/tp] is shard r's
    columns of the conv output, ``ps[r]`` its parameters (``w_a``/``w_x``
    rows [W/tp, W]).  The two products' partials go through one
    :func:`reduce_sum`; each shard keeps its own columns."""
    Wl = convs[0].shape[-1]
    W = ps[0]["w_a"].shape[1]
    xfs = [c.float() for c in convs]
    sums = reduce_sum([torch.cat([xf @ p["w_a"].float(),
                                  xf @ p["w_x"].float()], -1)
                       for p, xf in zip(ps, xfs)])
    out = []
    for r, (p, xf, tot) in enumerate(zip(ps, xfs, sums)):
        cols = slice(r * Wl, (r + 1) * Wl)
        out.append(_gate_values(p, xf, tot[..., :W][..., cols],
                                tot[..., W:][..., cols]))
    return out


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
        return out, _final_state(p, u, h)
    return out


def _final_state(p, u, h):
    """The decode cache a full sequence leaves: copies, not views (the
    state must not keep [B, S, W] alive)."""
    K = p["conv_w"].shape[0]
    hist = F.pad(u[:, -(K - 1):], (0, 0, max(0, K - 1 - u.shape[1]), 0))
    return {"h": h[:, -1].clone(), "conv": hist.clone()}


def _replicated(cfg, ps):
    """Every shard holds the whole width (it does not split)."""
    return ps[0]["conv_b"].shape[0] == cfg.lru_width


def apply_rglru_tp(cfg, ps, x, devices, *, return_state=False):
    """:func:`apply_rglru` over tensor-parallel shards (``ps[r]`` on
    ``devices[r]``; x replicated, on shard 0's device) → the output on
    shard 0's device, and with ``return_state`` each shard's decode cache
    (its W/tp columns, or the whole width where it is replicated).  A
    replicated block whose states nobody keeps (a train step's) runs on
    shard 0 alone, whose output is the one read."""
    if _replicated(cfg, ps) and not return_state:
        return apply_rglru(cfg, ps[0], x)
    xs = broadcast(x, devices)
    if _replicated(cfg, ps):
        outs = [apply_rglru(cfg, p, xr, return_state=return_state)
                for p, xr in zip(ps, xs)]
        return (outs[0][0], [st for _, st in outs]) if return_state \
            else outs[0]
    branches = [_branches(p, xr) for p, xr in zip(ps, xs)]
    convs = [causal_conv(u, p["conv_w"], p["conv_b"])
             for p, (_, u) in zip(ps, branches)]
    hs = [lru_ops.rglru_scan(a.contiguous(), bx.contiguous())
          for a, bx in _gates_tp(ps, convs)]
    out = reduce_sum([(h.to(x.dtype) * g) @ p["w_out"].to(x.dtype)
                      for p, h, (g, _) in zip(ps, hs, branches)])[0]
    if return_state:
        return out, [_final_state(p, u, h)
                     for p, h, (_, u) in zip(ps, hs, branches)]
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
    hist, conv_out = _conv_step(p, u, cache)
    a, bx = _gates(p, conv_out[:, None])
    return _step_out(p, x, cache, hist, gate, a, bx)


def _conv_step(p, u, cache):
    """The conv's history with the new input appended, and its output."""
    hist = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(u.dtype)
    conv_out = torch.einsum("bkw,kw->bw", hist.to(u.dtype), w) \
        + p["conv_b"].to(u.dtype)
    return hist, conv_out


def _step_out(p, x, cache, hist, gate, a, bx):
    """Advance the cache in place; → the step's output projection."""
    h = a[:, 0] * cache["h"] + bx[:, 0]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    y = h.to(x.dtype)[:, None] * gate
    return y @ p["w_out"].to(x.dtype)


def decode_rglru_tp(cfg, ps, x, caches, devices):
    """:func:`decode_rglru` over tensor-parallel shards: ``caches[r]`` is
    shard r's cache (W/tp columns, or the whole width), updated in place
    → the output on shard 0's device."""
    xs = broadcast(x, devices)
    if _replicated(cfg, ps):
        return [decode_rglru(cfg, p, xr, c)
                for p, xr, c in zip(ps, xs, caches)][0]
    branches = [_branches(p, xr) for p, xr in zip(ps, xs)]
    steps = [_conv_step(p, u, c)
             for p, (_, u), c in zip(ps, branches, caches)]
    gates = _gates_tp(ps, [co[:, None] for _, co in steps])
    return reduce_sum([
        _step_out(p, xr, c, hist, g, a, bx)
        for p, xr, c, (hist, _), (g, _), (a, bx)
        in zip(ps, xs, caches, steps, branches, gates)])[0]
