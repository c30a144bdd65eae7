"""Mamba-2 block with the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

Counterpart of ``repro/models/ssd.py``.  Prefill runs the chunk scan in
the hand-written kernel (:mod:`repro_torch.kernels.ssd`), whose wrapper
picks the kernel or its plain version by the tensors' device; decode is
the O(1)-state recurrent step in plain tensor code (the reference has no
kernel there either).  The reference's numerics are kept: the ``D`` skip
in float32, ``y`` cast to the activation dtype before the ``silu(z)``
gate, the gated RMSNorm in float32 with eps 1e-6 and ``1 + norm_scale``.

Under tensor parallelism (:func:`apply_ssd_tp`, :func:`decode_ssd_tp`) the
parameters keep the serving rules' placement, which splits *fused* dims
evenly: ``w_in``'s columns ``[z | x | B | C | dt]`` and the conv's ``[x |
B | C]`` do not break at the segments.  So each step is explicit: the
column-parallel projection, a :func:`~repro_torch.sharding.placement.
regroup` into the conv layout (the conv's even split, which is also the
conv state's) beside z and dt by heads, the conv, and a second regroup
into the heads layout (x by heads, B and C on every shard).  The scan
then runs at H/tp heads; the gated RMSNorm's mean over the whole
``d_inner`` takes one :func:`reduce_sum` of the per-row sums of squares,
and ``w_out`` (its rows split as the heads are) is row-parallel.

Each of those dims is split only where the rules split it
(:func:`tp_splits`); one that does not divide the shard count is whole
on every shard (:func:`tp_layout`).  At mamba2-2.7b's widths over three
shards only the conv splits: every shard forms the whole projection,
convolves its own columns, and the conv outputs are gathered to every
shard's scan over all 80 heads, whose state each shard keeps whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.sharding.placement import (
    broadcast,
    even_bounds,
    reduce_sum,
    regroup,
)

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


# ---------------------------------------------------------------------------
# tensor parallelism: shards by heads, parameters in the rules' layout


def tp_splits(cfg, ps) -> dict:
    """Which of the block's dims the shards' parameters ``ps`` split:
    ``fused`` (``w_in``'s columns), ``conv`` (the conv's columns),
    ``inner`` (``w_out``'s rows and ``norm_scale``) and ``heads`` (the
    scan's heads and the ``ssm`` state: split where the shard count
    divides them, as the serving rules split the state)."""
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    tp = len(ps)
    return {"fused": ps[0]["w_in"].shape[1] != 2 * DI + 2 * N + H,
            "conv": ps[0]["conv_w"].shape[1] != DI + 2 * N,
            "inner": ps[0]["w_out"].shape[0] != DI,
            "heads": H % tp == 0 and H >= tp}


def tp_layout(cfg, tp, *, fused=True, conv=True, inner=True, heads=True):
    """The column ranges of the sharded block, a list of ``(lo, hi)`` a
    shard in global coordinates; a dim that is not split gives every
    shard the whole range.  ``fused`` (what each shard's projection
    holds: w_in's even split), ``conv`` (the conv's), ``inner`` (w_out's
    rows), ``head_bounds`` (the scan's heads), ``proj`` (per shard: its z
    and dt by heads and its conv columns, in w_in's coordinates) and
    ``heads`` (per shard: its x by heads, then all of B and C, in the
    conv's coordinates)."""
    DI, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads

    def bounds(n, split):
        return even_bounds(n, tp) if split else [(0, n)] * tp
    hb, xb = bounds(H, heads), bounds(DI, heads)
    conv_b = bounds(DI + 2 * N, conv)
    dt0 = 2 * DI + 2 * N
    proj = [[xb[r], (DI + a, DI + b), (dt0 + hb[r][0], dt0 + hb[r][1])]
            for r, (a, b) in enumerate(conv_b)]
    return {"fused": bounds(2 * DI + 2 * N + H, fused), "conv": conv_b,
            "inner": bounds(DI, inner), "head_bounds": hb, "proj": proj,
            "heads": [[xb[r], (DI, DI + 2 * N)] for r in range(tp)],
            "split": dict(fused=fused, conv=conv, inner=inner, heads=heads)}


def _split_proj_tp(lay, projs, devices):
    """Each shard's (z, conv input, dt) from the shards' projections (a
    column-parallel split, or each shard's whole projection)."""
    out = []
    for r, t in enumerate(regroup(projs, lay["fused"], lay["proj"],
                                  devices)):
        (z0, z1), (c0, c1), _ = lay["proj"][r]
        nz, nc = z1 - z0, c1 - c0
        out.append((t[..., :nz], t[..., nz:nz + nc], t[..., nz + nc:]))
    return out


def _split_conv_tp(cfg, lay, convs, devices):
    """Each shard's (x by heads, B, C) from the shards' conv outputs."""
    N = cfg.ssm_state
    out = []
    for r, t in enumerate(regroup(convs, lay["conv"], lay["heads"],
                                  devices)):
        nx = lay["heads"][r][0][1] - lay["heads"][r][0][0]
        out.append((t[..., :nx], t[..., nx:nx + N], t[..., nx + N:]))
    return out


def _head_params(p, hb):
    """A shard's heads ``hb`` of the replicated per-head vectors."""
    hs = slice(*hb)
    return p["a_log"][hs], p["dt_bias"][hs], p["d_skip"][hs]


def _gate_norm_out_tp(lay, ps, ys, zs, d_inner):
    """:func:`_gate_norm_out` over shards → the output on shard 0's
    device.  Heads split: ``ys[r]``/``zs[r]`` are shard r's heads; the
    mean square over the whole ``d_inner`` is the :func:`reduce_sum` of
    the shards' per-row sums, then each shard's normed slice goes through
    its rows of ``w_out`` (a partial sum).  Heads replicated: every shard
    holds the whole of y; with ``w_out`` whole shard 0's block is the
    answer, with its rows split each shard puts its columns of the
    normed y through them."""
    split = lay["split"]
    if not split["heads"] and not split["inner"]:
        return _gate_norm_out(ps[0], ys[0], zs[0])
    gated = [y.to(z.dtype) * F.silu(z) for y, z in zip(ys, zs)]
    sq = [g.float().square().sum(-1, keepdim=True) for g in gated]
    sums = reduce_sum(sq) if split["heads"] else sq
    outs = []
    for p, g, ss, (lo, hi) in zip(ps, gated, sums, lay["inner"]):
        normed = g.float() * torch.rsqrt(ss / d_inner + _NORM_EPS)
        if not split["heads"]:
            normed = normed[..., lo:hi]
        normed = (normed * (1.0 + p["norm_scale"].float())).to(g.dtype)
        outs.append(normed @ p["w_out"].to(g.dtype))
    return reduce_sum(outs)[0]


def apply_ssd_tp(cfg, ps, x, devices, *, return_state=False):
    """:func:`apply_ssd` over tensor-parallel shards (``ps[r]`` on
    ``devices[r]``; x replicated, on shard 0's device) → the output on
    shard 0's device, and with ``return_state`` each shard's decode cache:
    ``ssm`` at its heads (all of them where they do not split), ``conv``
    its columns of the conv layout (all of them where they do not
    split).  A block that splits nothing, whose states nobody keeps (a
    train step's), runs on shard 0 alone, whose output is the one read."""
    splits = tp_splits(cfg, ps)
    if not (return_state or any(splits.values())):
        return apply_ssd(cfg, ps[0], x)
    b, S, _ = x.shape
    P = cfg.ssm_headdim
    lay = tp_layout(cfg, len(ps), **splits)
    xs = broadcast(x, devices)
    split = _split_proj_tp(lay, [xr @ p["w_in"].to(x.dtype)
                                 for p, xr in zip(ps, xs)], devices)
    convs = [F.silu(causal_conv(cin, p["conv_w"], p["conv_b"]))
             for p, (_, cin, _) in zip(ps, split)]
    ys, states = [], []
    for p, hb, (xi, B_, C_), (_, _, dt) in zip(
            ps, lay["head_bounds"], _split_conv_tp(cfg, lay, convs, devices),
            split):
        a_log, dt_bias, d_skip = _head_params(p, hb)
        dt = softplus(dt.float() + dt_bias.float())
        xh = xi.reshape(b, S, hb[1] - hb[0], P)
        y, state = ssd_ops.ssd_chunked(xh, dt, a_log, B_, C_,
                                       chunk=cfg.ssm_chunk)
        y = y + xh.float() * d_skip.float()[None, None, :, None]
        ys.append(y.reshape(b, S, -1))
        states.append(state)
    out = _gate_norm_out_tp(lay, ps, ys, [z for z, _, _ in split],
                            cfg.d_inner)
    if not return_state:
        return out
    K = ps[0]["conv_w"].shape[0]
    return out, [{"ssm": st, "conv": F.pad(
        cin[:, -(K - 1):], (0, 0, max(0, K - 1 - S), 0)).clone()}
        for st, (_, cin, _) in zip(states, split)]


def decode_ssd_tp(cfg, ps, x, caches, devices):
    """:func:`decode_ssd` over tensor-parallel shards: ``caches[r]`` is
    shard r's cache (its heads of ``ssm``, its conv-layout columns of
    ``conv``: whole where they do not split), updated in place → the
    output on shard 0's device."""
    b = x.shape[0]
    P = cfg.ssm_headdim
    lay = tp_layout(cfg, len(ps), **tp_splits(cfg, ps))
    xs = broadcast(x, devices)
    split = _split_proj_tp(lay, [xr @ p["w_in"].to(x.dtype)
                                 for p, xr in zip(ps, xs)], devices)
    hists, convs = [], []
    for p, c, xr, (_, pre, _) in zip(ps, caches, xs, split):
        hist = torch.cat([c["conv"], pre.to(c["conv"].dtype)], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", hist.to(xr.dtype),
                                p["conv_w"].to(xr.dtype)) \
            + p["conv_b"].to(xr.dtype)
        hists.append(hist)
        convs.append(F.silu(conv_out))
    ys = []
    for p, c, hist, hb, (xi, B_, C_), (_, _, dt) in zip(
            ps, caches, hists, lay["head_bounds"],
            _split_conv_tp(cfg, lay, convs, devices), split):
        a_log, dt_bias, d_skip = _head_params(p, hb)
        dt1 = softplus(dt[:, 0].float() + dt_bias.float())       # [B,Hl]
        dA = torch.exp(dt1 * -torch.exp(a_log.float()))
        xh = xi.reshape(b, hb[1] - hb[0], P).float()
        h = c["ssm"]
        h.mul_(dA[..., None, None]).add_(
            (xh * dt1[..., None])[..., None] * B_.float()[:, None, None, :])
        y = (h @ C_.float()[:, None, :, None])[..., 0]
        y = y + xh * d_skip.float()[None, :, None]
        c["conv"].copy_(hist[:, 1:])
        ys.append(y.reshape(b, 1, -1))
    return _gate_norm_out_tp(lay, ps, ys, [z for z, _, _ in split],
                             cfg.d_inner)
