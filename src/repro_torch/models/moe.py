"""Top-k mixture-of-experts FFN with capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``.  Experts are SwiGLU MLPs stored
stacked ``[E, ...]``.  Each token's top-k assignments queue at their
experts in token-major, k-minor order; an expert keeps the first
``capacity`` of its queue and the rest drop (GShard semantics), so the
shapes stay static and a token's output depends on which tokens share
the call.  ``capacity`` is a host int computed from the call's whole
token count, padding and idle decode slots included, exactly as the
reference computes it.

On one device the reference's ``grouped`` and ``shard_map`` dispatch both
fall through to its global scatter dispatch, which is the only one here
(tensor and expert parallelism wait for ROADMAP.md §A.11).  The expert
products are batched matrix products over all ``E`` experts' capacity
buffers, as the reference's einsums are; the dispatch and combine are
index operations.  Nothing here reads a tensor back to the host, so the
step can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import PSpec


def moe_schema(cfg) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PSpec((D, E)),
        "w_gate": PSpec((E, D, Fd), fan_in_axes=(1,)),
        "w_up": PSpec((E, D, Fd), fan_in_axes=(1,)),
        "w_down": PSpec((E, Fd, D), fan_in_axes=(1,)),
    }


def expert_capacity(cfg, n_tokens: int) -> int:
    """Queue slots per expert for a call over ``n_tokens`` tokens (the
    reference's ``max(int(K*N*cf/E), K)``, in the same float order)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    return max(int(K * n_tokens * cfg.moe_capacity_factor / E), K)


def route(cfg, p, xt):
    """Router over tokens ``xt`` [N, D], in float32 → (probs [N, E], gate
    [N, K], idx [N, K]).  Ties go to the lower expert index, as
    ``lax.top_k`` breaks them (a stable descending sort; ``torch.topk``
    promises no order).  The gates are renormalised over the K."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.num_experts_per_tok
    gate, idx = gate[:, :K], idx[:, :K]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    return probs, gate, idx


def queue_positions(idx, num_experts: int):
    """Each assignment's place in its expert's queue, token-major and
    k-minor: ``idx`` [N, K] → [N·K] int64, counting from 0."""
    flat_e = idx.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(num_experts,
                                              device=idx.device)).long()
    return onehot.cumsum(0).gather(1, flat_e[:, None])[:, 0] - 1


def apply_moe(cfg, p, x):
    """x: [B, S, D] → (y [B, S, D], Switch load-balancing aux loss)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    N = B * S
    xt = x.reshape(N, D)
    probs, gate, idx = route(cfg, p, xt)
    C = expert_capacity(cfg, N)

    flat_e = idx.reshape(-1)                              # [NK]
    pos = queue_positions(idx, E)
    keep = pos < C
    flat_c = torch.where(keep, pos, torch.full_like(pos, C))
    # the token in each (expert, slot): a kept slot receives exactly one
    # assignment; the overflow column C takes every dropped one and is
    # thrown away, and an empty slot reads row N, a row of zeros (the
    # reference's scatter-add into a zero buffer gives the same values)
    tok = torch.arange(N * K, device=x.device) // K
    slot_tok = torch.full((E * (C + 1),), N, dtype=torch.long,
                          device=x.device)
    slot_tok.scatter_(0, flat_e * (C + 1) + flat_c, tok)
    slot_tok = slot_tok.view(E, C + 1)[:, :C]
    xe = torch.cat([xt, xt.new_zeros(1, D)])[slot_tok]    # [E, C, D]

    g = torch.bmm(xe, p["w_gate"].to(x.dtype))
    u = torch.bmm(xe, p["w_up"].to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(x.dtype))  # [E, C, D]

    got = ye[flat_e, flat_c.clamp(max=C - 1)]             # [NK, D]
    w = (keep.to(gate.dtype) * gate.reshape(-1)).to(x.dtype)
    y = (got * w[:, None]).reshape(N, K, D).sum(1)

    me = probs.mean(0)
    ce = (idx[..., None] == torch.arange(E, device=x.device)).float() \
        .sum(1).mean(0)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, D), aux
