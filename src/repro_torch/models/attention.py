"""Grouped-query attention for the dense family: projections, the plain
masked attention, full-sequence attention (forward and prefix-aware
prefill) and one-token decode over block-paged KV pools.

Counterpart of ``repro/models/attention.py``.  Both attention products
run in hand-written kernels: ``full_attention`` in the flash kernel and
``paged_decode_attention`` in the paged decode kernel.  Their wrappers
pick the kernel or its plain version by the tensors' device, so this
module has no implementation switch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

from .common import PSpec, apply_rope, rmsnorm, rope_cos_sin

NEG_INF = -2.0e38


def attn_schema(cfg) -> dict:
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": PSpec((D, H, hd)),
        "wk": PSpec((D, KVH, hd)),
        "wv": PSpec((D, KVH, hd)),
        "wo": PSpec((H, hd, D), fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        s["bq"] = PSpec((H, hd), "zeros")
        s["bk"] = PSpec((KVH, hd), "zeros")
        s["bv"] = PSpec((KVH, hd), "zeros")
    if cfg.qk_norm:
        s["q_norm"] = PSpec((hd,), "zeros")
        s["k_norm"] = PSpec((hd,), "zeros")
    return s


def _proj(x, w):
    """einsum("bsd,dhk->bshk") as one matmul."""
    D, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * hd)).view(*x.shape[:-1], H, hd)


def _project_q(cfg, p, x):
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(cfg, p, x):
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "k_norm" in p:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def _out_proj(out, wo):
    """einsum("bshk,hkd->bsd")."""
    H, hd, D = wo.shape
    return out.reshape(*out.shape[:2], H * hd) @ wo.to(out.dtype).reshape(
        H * hd, D)


def mha_reference(q, k, v, *, mask=None):
    """Plain grouped-query attention.  q: [B,S,H,hd]; k,v: [B,T,KVH,hd];
    mask: [B|1,1,S,T] boolean (True = keep)."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q.reshape(B, S, KVH, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask[:, :, None], scores,
                             torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def causal_mask(S, T, *, offset=0, window=0, device=None):
    """[1, 1, S, T] boolean keep-mask.  offset = (T - S) for prefix caches."""
    qpos = torch.arange(S, device=device)[:, None] + offset
    kpos = torch.arange(T, device=device)[None, :]
    keep = kpos <= qpos
    if window > 0:
        keep &= kpos > qpos - window
    return keep[None, None]


def prefix_causal_mask(S, Tpad, prefix_len, device=None):
    """[1, 1, S, Tpad+S] keep-mask for suffix queries over a padded KV
    prefix followed by the suffix's own keys: prefix key j is valid iff
    j < prefix_len, suffix keys are causal."""
    keep_prefix = (torch.arange(Tpad, device=device)[None, :]
                   < prefix_len).expand(S, Tpad)
    qpos = torch.arange(S, device=device)[:, None]
    keep_self = torch.arange(S, device=device)[None, :] <= qpos
    return torch.cat([keep_prefix, keep_self], dim=1)[None, None]


def full_attention(cfg, p, x, *, positions, window=0, return_kv=False,
                   prefix_kv=None, prefix_len=0):
    """Causal self-attention over a full sequence (forward / prefill).

    prefix_kv: optional ``(k, v)`` of an already-prefilled prompt prefix
        ([B, Tpad, KVH, hd], post-RoPE, zero-padded beyond ``prefix_len``,
        a host int).  x is then the prompt *suffix*, whose queries attend
        the valid prefix keys plus their own causal keys; ``return_kv``
        returns only the suffix K/V.  Requires global attention.
    """
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if prefix_kv is not None:
        if window:
            raise ValueError("prefix attention is global attention only")
        pk, pv = prefix_kv
        Tpad = pk.shape[1]
        out = fa_ops.flash_attention(
            q.contiguous(), torch.cat([pk.to(k.dtype), k], 1),
            torch.cat([pv.to(v.dtype), v], 1), causal=True,
            prefix_pad=Tpad, prefix_len=prefix_len)
    else:
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True,
                                     window=window)
    out = _out_proj(out, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# paged decode (block-paged KV pools)


def init_paged_kv_cache(cfg, num_pages, page_size, dtype, device):
    """Block-paged KV pool: [num_pages, page_size, KVH, hd] per leaf."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "int8 KV waits for the contiguous engine (ROADMAP.md §A.6)")
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_decode_attention(cfg, p, x, cache, positions, page_table):
    """One-token decode over paged KV: x [B,1,D]; cache k/v pools
    [P,ps,KVH,hd]; positions [B] (index of the current token); page_table
    [B,N] int32 — entry n holds the pool page storing positions
    [n·ps, (n+1)·ps).  Returns out [B,1,D].

    The current token's K/V is written into page ``table[b, pos // ps]``
    at offset ``pos % ps`` **in place** on the pool tensors (the JAX
    reference donated the pool buffer and returned a new one; writing in
    place is the same without the copy).  Retired slots point every table
    entry at the scratch page 0, where their dead writes land harmlessly.
    """
    ps = cache["k"].shape[1]
    N = page_table.shape[1]
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim,
                                cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    page_ids = torch.gather(
        page_table, 1,
        torch.clamp(positions // ps, max=N - 1)[:, None].long())[:, 0].long()
    offs = (positions % ps).long()
    cache["k"][page_ids, offs] = k[:, 0].to(cache["k"].dtype)
    cache["v"][page_ids, offs] = v[:, 0].to(cache["v"].dtype)
    lengths = (positions + 1).to(torch.int32)
    out = pa_ops.paged_decode_attention(q.contiguous(), cache["k"],
                                        cache["v"], page_table, lengths)
    return _out_proj(out, p["wo"])
