"""Grouped-query attention: projections, the plain masked attention,
full-sequence attention (forward, prefix-aware prefill, the encoder's
non-causal self-attention and cross-attention), one-token
decode over a contiguous or ring KV cache (optionally int8) and over
block-paged KV pools.

Counterpart of ``repro/models/attention.py``.  Every attention product
runs in a hand-written kernel: ``full_attention`` in the flash kernel,
``decode_attention`` in the contiguous decode kernel (dense or int8) and
``paged_decode_attention`` in the paged decode kernel.  Their wrappers
pick the kernel or its plain version by the tensors' device, so this
module has no implementation switch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_attention import ops as pa_ops

from .common import PSpec, apply_rope, rmsnorm, rope_cos_sin

NEG_INF = -2.0e38


def attn_schema(cfg, *, cross=False) -> dict:
    """Projection leaves; ``cross`` (the decoder's cross-attention) has no
    QKV bias and no qk-norm."""
    D, H, KVH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = {
        "wq": PSpec((D, H, hd)),
        "wk": PSpec((D, KVH, hd)),
        "wv": PSpec((D, KVH, hd)),
        "wo": PSpec((H, hd, D), fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = PSpec((H, hd), "zeros")
        s["bk"] = PSpec((KVH, hd), "zeros")
        s["bv"] = PSpec((KVH, hd), "zeros")
    if cfg.qk_norm and not cross:
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


def full_attention(cfg, p, x, *, positions, kv_x=None, kv=None,
                   causal=True, window=0, return_kv=False, prefix_kv=None,
                   prefix_len=0):
    """Full-sequence attention (forward / prefill / encoder / cross).

    kv_x: source of keys and values (cross-attention, no RoPE; non-causal:
        every query row attends every ``kv_x`` row) — defaults to x.
    kv: cross-attention keys and values already projected from ``kv_x``
        (:func:`cross_attention_cache`), in place of ``kv_x``.
    causal: False for the encoder's self-attention.
    prefix_kv: optional ``(k, v)`` of an already-prefilled prompt prefix
        ([B, Tpad, KVH, hd], post-RoPE, zero-padded beyond ``prefix_len``,
        a host int).  x is then the prompt *suffix*, whose queries attend
        the valid prefix keys plus their own causal keys; ``return_kv``
        returns only the suffix K/V.  Requires causal global
        self-attention.
    """
    cross = kv_x is not None or kv is not None
    if cross and causal:
        raise ValueError("cross-attention (kv_x, kv) is non-causal")
    if kv_x is not None and kv is not None:
        raise ValueError("pass kv_x or its projection kv, not both")
    q = _project_q(cfg, p, x)
    k, v = kv if kv is not None else _project_kv(
        cfg, p, x if kv_x is None else kv_x)
    if cfg.use_rope and not cross:
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                                x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if prefix_kv is not None:
        if window or not causal or cross:
            raise ValueError("prefix attention is causal global "
                             "self-attention only")
        pk, pv = prefix_kv
        Tpad = pk.shape[1]
        out = fa_ops.flash_attention(
            q.contiguous(), torch.cat([pk.to(k.dtype), k], 1),
            torch.cat([pv.to(v.dtype), v], 1), causal=True,
            prefix_pad=Tpad, prefix_len=prefix_len)
    else:
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=causal,
                                     window=window)
    out = _out_proj(out, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def cross_attention_cache(cfg, p, enc_out):
    """Cross-attention K/V [B, enc_seq, KVH, hd] of the encoder output (the
    encoder-decoder's decode memory)."""
    k, v = _project_kv(cfg, p, enc_out)
    return {"k": k, "v": v}


# ---------------------------------------------------------------------------
# cached decode (contiguous or ring KV cache)


def init_kv_cache(cfg, batch, capacity, dtype, device):
    """Contiguous KV cache ``[batch, capacity, KVH, hd]`` per leaf; with
    ``kv_cache_dtype == "int8"`` int8 leaves plus an f32 scale
    ``[batch, capacity, KVH]`` per K and V."""
    shape = (batch, capacity, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x):
    """Per-(position, head) symmetric int8 (the reference's KIVI-style
    scheme, bit for bit).  x: [..., hd] → (q int8 [..., hd], scale f32
    [...]); ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype):
    """int8 values times their scale, in ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)


def pack_kv(cfg, k, v):
    """Cache leaves for freshly computed K/V [B,S,KVH,hd]."""
    if cfg.kv_cache_dtype == "int8":
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    return {"k": k, "v": v}


def decode_valid(positions, C, window):
    """[B, C] bool: cache slot j holds a position the current token
    attends.  A full cache (window 0) holds position j at slot j; a ring
    buffer of C = window slots holds position p at slot p % C, so once a
    row has wrapped (pos >= C) every slot is live."""
    j = torch.arange(C, device=positions.device)[None, :]
    pos = positions.long()[:, None]
    valid = j <= pos
    if window > 0:
        valid = valid | (pos >= C)
    return valid


def decode_attention(cfg, p, x, cache, positions, *, window=0):
    """One-token decode over a contiguous cache: x [B,1,D]; cache k/v
    [B,C,KVH,hd] (int8 with scales when ``kv_cache_dtype == "int8"``);
    positions [B] is the index of the *current* token.  Returns out
    [B,1,D].

    The step's (packed) K/V are written into slot ``pos`` — ``pos % C``
    for a windowed ring buffer — of ``cache`` **in place** (the JAX
    reference donated the cache and returned a new one).  Keys are
    stored post-RoPE, so ring order does not matter under the validity
    mask."""
    B = x.shape[0]
    C = cache["k"].shape[1]
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim,
                                cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    slots = (positions % C if window > 0 else positions).long()
    rows = torch.arange(B, device=x.device)
    for name, new in pack_kv(cfg, k, v).items():
        cache[name][rows, slots] = new[:, 0].to(cache[name].dtype)
    valid = decode_valid(positions, C, window)
    if cfg.kv_cache_dtype == "int8":
        out = da_ops.decode_attention_int8(
            q.contiguous(), cache["k"], cache["v"], cache["k_scale"],
            cache["v_scale"], valid)
    else:
        out = da_ops.decode_attention(q.contiguous(), cache["k"],
                                      cache["v"], valid)
    return _out_proj(out, p["wo"])


def cross_decode_attention(cfg, p, x, ck, cv, valid):
    """One decoder token's cross-attention over the fixed encoder memory:
    x [B,1,D]; ck/cv [B, enc_seq, KVH, hd] from
    :func:`cross_attention_cache`; valid [B, enc_seq] all true (every
    frame is attended; the caller makes it once a step).  Runs in the
    contiguous decode kernel.  Returns out [B,1,D]."""
    q = _project_q(cfg, p, x)
    out = da_ops.decode_attention(q.contiguous(), ck, cv, valid)
    return _out_proj(out, p["wo"])


# ---------------------------------------------------------------------------
# paged decode (block-paged KV pools)


def init_paged_kv_cache(cfg, num_pages, page_size, dtype, device):
    """Block-paged KV pool: [num_pages, page_size, KVH, hd] per leaf."""
    if cfg.kv_cache_dtype == "int8":
        raise ValueError(
            "paged KV requires unquantized KV: int8 KV runs on the "
            "contiguous engine")
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
