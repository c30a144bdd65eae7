"""Top-k mixture-of-experts FFN with capacity-bounded dispatch.

Counterpart of ``repro/models/moe.py``.  Experts are SwiGLU MLPs stored
stacked ``[E, ...]``.  Each token's top-k assignments queue at their
experts in token-major, k-minor order; an expert keeps the first
``capacity`` of its queue and the rest drop (GShard semantics), so the
shapes stay static and a token's output depends on which tokens share
the call.  ``capacity`` is a host int computed from the call's whole
token count, padding and idle decode slots included, exactly as the
reference computes it.

Three dispatches, picked by :func:`apply_moe` as the reference picks
them (``cfg.moe_dispatch`` and the active sharding rules): the global one
(:func:`apply_moe_global`; one device, or no rules), the ``grouped`` one
(:func:`apply_moe_grouped`: g data-shard groups, each with its own
capacity; taken only when the rules' data axes exceed 1, which no serving
mesh has) and the ``shard_map`` one (:func:`apply_moe_tp`: expert
parallelism over the ``model`` axis, each shard running its own experts
on the replicated tokens and one :func:`reduce_sum` adding the partial
outputs).  The expert products are batched matrix products over the
experts' capacity buffers, as the reference's einsums are; the dispatch
and combine are index operations.  Nothing here reads a tensor back to
the host, so the step can be captured in a CUDA graph.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.placement import broadcast, reduce_sum
from repro_torch.sharding.rules import active_rules

from .common import PSpec


def moe_schema(cfg) -> dict:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": PSpec((D, E), axes=("embed", "experts_router")),
        "w_gate": PSpec((E, D, Fd), fan_in_axes=(1,),
                        axes=("experts", "embed", "moe_ffn")),
        "w_up": PSpec((E, D, Fd), fan_in_axes=(1,),
                      axes=("experts", "embed", "moe_ffn")),
        "w_down": PSpec((E, Fd, D), fan_in_axes=(1,),
                        axes=("experts", "moe_ffn", "embed")),
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


def _dp_group_count() -> int:
    """The product of the active rules' data axes (1 without rules)."""
    rules = active_rules()
    if rules is None:
        return 1
    sizes = dict(zip(rules.mesh.axis_names, rules.mesh.devices.shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)


def apply_moe(cfg, p, x):
    """x: [B, S, D] → (y [B, S, D], Switch load-balancing aux loss), by
    the dispatch the reference picks: ``grouped`` when the active rules'
    data axes number g > 1 and divide the token count; ``shard_map`` when
    rules over more than one device are active (the experts split over
    their ``model`` axis, falling back to the global dispatch where that
    does not divide the expert count); else the global dispatch."""
    if cfg.moe_dispatch == "grouped":
        g = _dp_group_count()
        if g > 1 and (x.shape[0] * x.shape[1]) % g == 0:
            return apply_moe_grouped(cfg, p, x, g)
    if cfg.moe_dispatch == "shard_map":
        rules = active_rules()
        if rules is not None and rules.mesh.devices.size > 1:
            return _apply_moe_on_mesh(cfg, p, x, rules.mesh)
    return apply_moe_global(cfg, p, x)


def _aux_loss(probs, idx, E):
    me = probs.reshape(-1, E).mean(0)
    ce = (idx[..., None] == torch.arange(E, device=idx.device)).float() \
        .sum(-2).reshape(-1, E).mean(0)
    return E * torch.sum(me * ce)


def _experts(p, xt, flat_e, flat_c, keep, gate, n_experts, C, K):
    """Run the experts ``p`` (leaves ``[n_experts, ...]``) on the
    assignments (token ``i // K`` of ``xt`` [N, D] to slot ``flat_c[i]``
    of expert ``flat_e[i]``; ``keep[i]`` false drops it) and combine the
    kept ones by their gates → y [N, D].  A kept slot receives exactly
    one assignment; the overflow column C takes every dropped one and is
    thrown away, and an empty slot reads row N, a row of zeros (the
    reference's scatter-add into a zero buffer gives the same values)."""
    N, D = xt.shape
    tok = torch.arange(N * K, device=xt.device) // K
    slot_tok = torch.full((n_experts * (C + 1),), N, dtype=torch.long,
                          device=xt.device)
    slot_tok.scatter_(0, flat_e * (C + 1) + flat_c, tok)
    slot_tok = slot_tok.view(n_experts, C + 1)[:, :C]
    xe = torch.cat([xt, xt.new_zeros(1, D)])[slot_tok]   # [E, C, D]
    g = torch.bmm(xe, p["w_gate"].to(xt.dtype))
    u = torch.bmm(xe, p["w_up"].to(xt.dtype))
    ye = torch.bmm(F.silu(g) * u, p["w_down"].to(xt.dtype))
    got = ye[flat_e, flat_c.clamp(max=C - 1)]            # [NK, D]
    w = (keep.to(gate.dtype) * gate.reshape(-1)).to(xt.dtype)
    return (got * w[:, None]).reshape(N, K, D).sum(1)


def apply_moe_global(cfg, p, x):
    """The global scatter dispatch: x [B, S, D] → (y, aux)."""
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
    y = _experts(p, xt, flat_e, flat_c, keep, gate, E, C, K)
    return y.reshape(B, S, D), _aux_loss(probs, idx, E)


def apply_moe_grouped(cfg, p, x, g):
    """The ``grouped`` dispatch (the reference's ``apply_moe_grouped``):
    the N tokens split into ``g`` consecutive groups of n = N/g, each
    routed with its own capacity ``expert_capacity(cfg, n)`` and its own
    expert queues (per-worker capacity); the aux loss is over all tokens.
    → (y [B, S, D], aux)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    N = B * S
    if N % g:
        raise ValueError(f"{N} tokens do not split into {g} groups")
    n = N // g
    C = expert_capacity(cfg, n)
    ys, probs_all, idx_all = [], [], []
    for xg in x.reshape(g, n, D):
        probs, gate, idx = route(cfg, p, xg)
        pos = queue_positions(idx, E)
        keep = pos < C
        flat_c = torch.where(keep, pos, torch.full_like(pos, C))
        ys.append(_experts(p, xg, idx.reshape(-1), flat_c, keep, gate, E, C,
                           K))
        probs_all.append(probs)
        idx_all.append(idx)
    aux = _aux_loss(torch.stack(probs_all), torch.stack(idx_all), E)
    return torch.stack(ys).reshape(B, S, D), aux


def apply_moe_tp(cfg, ps, x, devices):
    """The ``shard_map`` dispatch (the reference's ``apply_moe_shardmap``)
    over tensor-parallel shards: ``ps[r]`` is shard r's MoE parameters on
    ``devices[r]`` (the router whole, experts ``[r·E/tp, (r+1)·E/tp)``);
    x [B, S, D] is replicated (one tensor, on shard 0's device).  The
    routing runs once and is broadcast, so every shard sees the same
    assignments; the capacity comes from the call's whole token count
    (the serving mesh's data axis is 1).  Each shard keeps the
    assignments both under capacity and its own, runs its experts on a
    local ``[E/tp, C, D]`` buffer and gate-weights its results; one
    :func:`reduce_sum` adds the partial outputs.  → (y on shard 0's
    device, aux)."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    tp = len(ps)
    if E % tp:
        raise ValueError(f"{E} experts do not split {tp} ways")
    e_loc = E // tp
    N = B * S
    xt = x.reshape(N, D)
    probs, gate, idx = route(cfg, ps[0], xt)
    C = expert_capacity(cfg, N)
    flat_e = idx.reshape(-1)
    pos = queue_positions(idx, E)
    parts = []
    for r, (p, xr, er, pr, gr) in enumerate(zip(
            ps, broadcast(xt, devices), broadcast(flat_e, devices),
            broadcast(pos, devices), broadcast(gate, devices))):
        keep = (pr < C) & (er // e_loc == r)
        loc_e = torch.where(keep, er - r * e_loc, torch.zeros_like(er))
        loc_c = torch.where(keep, pr, torch.full_like(pr, C))
        parts.append(_experts(p, xr, loc_e, loc_c, keep, gr, e_loc, C, K))
    y = reduce_sum(parts)[0]
    return y.reshape(B, S, D), _aux_loss(probs, idx, E)


def expert_shards(p, devices):
    """Shard r's MoE parameters of a whole parameter tree ``p``: the
    router whole, experts ``[r·E/tp, (r+1)·E/tp)``, on ``devices[r]``."""
    tp = len(devices)
    e_loc = p["w_gate"].shape[0] // tp
    return [{n: (w if n == "router" else w[r * e_loc:(r + 1) * e_loc]).to(d)
             for n, w in p.items()} for r, d in enumerate(devices)]


def _apply_moe_on_mesh(cfg, p, x, mesh):
    """``shard_map`` under rules on ``mesh`` with a whole parameter tree:
    the experts split over the ``model`` axis (:func:`expert_shards`), the
    tokens over the data axes in consecutive row blocks, each block run
    by :func:`apply_moe_tp` and its aux averaged over the blocks, as the
    reference's ``pmean`` does.  Falls back to the global dispatch where
    the model axis does not divide the expert count."""
    sizes = mesh.shape
    m = sizes.get("model", 1)
    if cfg.num_experts % m:
        return apply_moe_global(cfg, p, x)
    dp = mesh.devices.size // m
    first = mesh.devices.reshape(dp, m)
    ys, auxes = [], []
    for row, xb in zip(first, x.chunk(dp, dim=0)):
        devices = list(row)
        ps = expert_shards(p, devices)
        y, aux = apply_moe_tp(cfg, ps, xb.to(devices[0]), devices)
        ys.append(y.to(x.device))
        auxes.append(aux.to(x.device))
    return torch.cat(ys), torch.stack(auxes).mean()
