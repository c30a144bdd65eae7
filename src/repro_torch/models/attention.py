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

Under tensor parallelism (:mod:`.lm`'s sharded path) each shard calls
these functions with its own parameters: its q heads (and, where they
divide the shard count, its KV heads) and its rows of ``wo``, whose
product is a partial sum the caller reduces.  Where the KV heads are
replicated but the q heads are not, ``kv_runs`` splits the shard's q
heads into runs that read their KV heads in equal groups
(:func:`kv_head_runs`); the kernel runs once a run on that run's KV
heads alone, so its ``q_head // G`` mapping stays right, and the outputs
are concatenated in head order.  The decode kernels read a run's heads
of the cache or pool in place (a view narrowed along its heads), so no
step copies the cache.  A contiguous cache whose KV heads do
not split is split by *sequence* where its slots divide the shard count
(the serving rules' ``cache_pspecs``): :func:`decode_attention_seq_split`
runs every q head over each shard's slots and merges the shards'
partials; where the slots do not divide either, every shard holds the
whole cache and attends it with its own q heads.
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
        "wq": PSpec((D, H, hd), axes=("embed", "heads", "head_dim")),
        "wk": PSpec((D, KVH, hd), axes=("embed", "kv_heads", "head_dim")),
        "wv": PSpec((D, KVH, hd), axes=("embed", "kv_heads", "head_dim")),
        "wo": PSpec((H, hd, D), fan_in_axes=(0, 1),
                    axes=("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = PSpec((H, hd), "zeros", axes=("heads", "head_dim"))
        s["bk"] = PSpec((KVH, hd), "zeros", axes=("kv_heads", "head_dim"))
        s["bv"] = PSpec((KVH, hd), "zeros", axes=("kv_heads", "head_dim"))
    if cfg.qk_norm and not cross:
        s["q_norm"] = PSpec((hd,), "zeros", axes=("head_dim",))
        s["k_norm"] = PSpec((hd,), "zeros", axes=("head_dim",))
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


def kv_head_runs(num_heads, num_kv_heads, first, count):
    """The runs in which q heads ``[first, first + count)`` read their KV
    heads under GQA (q head h reads KV head ``h // (num_heads //
    num_kv_heads)``): ``((q_lo, q_hi, kv_lo, kv_hi), ...)`` in head order,
    the q range counted from ``first``.  A run is maximal: q heads that
    read KV heads ``[kv_lo, kv_hi)`` in equal consecutive groups, the
    only mapping a kernel given those KV heads alone computes.  Heads that
    read their KV heads in unequal groups give several runs (q heads
    [0, 8) of 40 over 8 KV heads: 5 over KV head 0, then 3 over KV head
    1)."""
    G = num_heads // num_kv_heads
    groups = []                       # [kv head, q heads reading it]
    for i in range(count):
        kv = (first + i) // G
        if groups and groups[-1][0] == kv:
            groups[-1][1] += 1
        else:
            groups.append([kv, 1])
    runs = []                         # [q_lo, q_hi, kv_lo, kv_hi, group]
    for kv, n in groups:
        if runs and runs[-1][4] == n:
            runs[-1][1] += n
            runs[-1][3] += 1
        else:
            q = runs[-1][1] if runs else 0
            runs.append([q, q + n, kv, kv + 1, n])
    return tuple(tuple(r[:4]) for r in runs)


def kv_head_range(num_heads, num_kv_heads, first, count):
    """(lo, hi): the KV heads that q heads ``[first, first + count)`` read
    under GQA (q head h reads KV head ``h // (num_heads // num_kv_heads)``).
    Raises unless they read ``[lo, hi)`` in equal consecutive groups (one
    run of :func:`kv_head_runs`), the only mapping a kernel given those KV
    heads alone computes."""
    runs = kv_head_runs(num_heads, num_kv_heads, first, count)
    lo, hi = runs[0][2], runs[-1][3]
    if len(runs) > 1:
        raise NotImplementedError(
            f"q heads [{first}, {first + count}) of {num_heads} read KV "
            f"heads [{lo}, {hi}) of {num_kv_heads} in unequal groups")
    return lo, hi


def _heads(t, lo, hi, dim=-2, copy=True):
    """``t`` narrowed to heads ``[lo, hi)`` of dim ``dim`` (``t`` itself
    where that is every head): a contiguous copy with ``copy``, else the
    view, which the decode kernels read in place."""
    if lo != 0 or hi != t.shape[dim]:
        t = t.narrow(dim, lo, hi - lo)
    return t.contiguous() if copy else t


def by_runs(q, kv_runs, attend, *kv, dims=None, views=False):
    """``attend(q, *kv)`` (q ``[..., H, hd]``; each of ``kv`` with its KV
    heads at ``dims[i]``, default -2) once a run of ``kv_runs``, on the
    run's q heads and KV heads alone, the outputs concatenated in head
    order; one call on every head where ``kv_runs`` is None.  With
    ``views`` each run's K/V are views of ``kv`` (the decode kernels read
    a cache narrowed to a run of heads in place); else contiguous copies
    (flash takes contiguous K/V: a prefill's own, not a cache)."""
    dims = dims or (-2,) * len(kv)
    kv_runs = kv_runs or ((0, q.shape[-2], 0, kv[0].shape[dims[0]]),)
    outs = [attend(_heads(q, a, b),
                   *(_heads(t, lo, hi, d, copy=not views)
                     for t, d in zip(kv, dims)))
            for a, b, lo, hi in kv_runs]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


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
                   prefix_len=0, kv_runs=None):
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
    kv_runs: the runs of :func:`kv_head_runs` (a shard whose q heads are
        sharded over replicated KV heads): the kernel runs once a run, on
        its KV heads alone; the returned K/V keep every head.
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
        out = by_runs(q, kv_runs, lambda qq, kk, vv: fa_ops.flash_attention(
            qq, kk, vv, causal=True, prefix_pad=Tpad, prefix_len=prefix_len),
            torch.cat([pk.to(k.dtype), k], 1),
            torch.cat([pv.to(v.dtype), v], 1))
    else:
        out = by_runs(q, kv_runs, lambda qq, kk, vv: fa_ops.flash_attention(
            qq, kk, vv, causal=causal, window=window), k, v)
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


def decode_attention(cfg, p, x, cache, positions, *, window=0,
                     kv_runs=None):
    """One-token decode over a contiguous cache: x [B,1,D]; cache k/v
    [B,C,KVH,hd] (int8 with scales when ``kv_cache_dtype == "int8"``);
    positions [B] is the index of the *current* token.  Returns out
    [B,1,D].

    The step's (packed) K/V are written into slot ``pos`` — ``pos % C``
    for a windowed ring buffer — of ``cache`` **in place** (the JAX
    reference donated the cache and returned a new one).  Keys are
    stored post-RoPE, so ring order does not matter under the validity
    mask.  ``kv_runs``: as :func:`full_attention`'s (the kernel then
    reads each run's KV heads of the cache in place)."""
    C = cache["k"].shape[1]
    q, k, v = decode_qkv(cfg, p, x, positions)
    write_decode_kv(cfg, cache, k, v,
                    (positions % C if window > 0 else positions).long())
    valid = decode_valid(positions, C, window)
    if cfg.kv_cache_dtype == "int8":
        out = by_runs(q, kv_runs, lambda qq, kk, vv, ks, vs:
                      da_ops.decode_attention_int8(qq, kk, vv, ks, vs, valid),
                      cache["k"], cache["v"], cache["k_scale"],
                      cache["v_scale"], dims=(-2, -2, -1, -1), views=True)
    else:
        out = by_runs(q, kv_runs, lambda qq, kk, vv: da_ops.decode_attention(
            qq, kk, vv, valid), cache["k"], cache["v"], views=True)
    return _out_proj(out, p["wo"])


def decode_qkv(cfg, p, x, positions):
    """q, k, v [B,1,·,hd] of one decode token, RoPE applied."""
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    if cfg.use_rope:
        cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim,
                                cfg.rope_theta, x.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def write_decode_kv(cfg, cache, k, v, slots, own=None):
    """Write the step's packed K/V [B,1,KVH,hd] into slot ``slots[b]`` of
    each row of ``cache`` in place.  ``own`` [B] bool (a shard of a cache
    split by sequence): only the rows it marks write; the others rewrite
    what their (clamped) slot holds, so the step reads nothing back to
    the host and stays capturable."""
    B = k.shape[0]
    rows = torch.arange(B, device=k.device)
    C = cache["k"].shape[1]
    if own is not None:
        slots = slots.clamp(0, C - 1)
    for name, new in pack_kv(cfg, k, v).items():
        buf = cache[name]
        val = new[:, 0].to(buf.dtype)
        if own is not None:
            keep = own.view((B,) + (1,) * (val.dim() - 1))
            val = torch.where(keep, val, buf[rows, slots])
        buf[rows, slots] = val


def decode_attention_seq_split(cfg, qs, caches, valids):
    """One-token attention over a contiguous cache split by sequence
    across shards: ``qs[r]`` [B,1,H,hd] (every q head, on shard r's
    device), ``caches[r]`` shard r's slots (dense or int8 with scales)
    and ``valids[r]`` [B, C_r] which of them the token attends.  Each
    shard runs the decode kernel's partial entry over its slots; the
    partials are stacked in rank order on shard 0's device and merged by
    one combine.  → out [B,1,H,hd] on shard 0's device."""
    parts = []
    for q, c, valid in zip(qs, caches, valids):
        if cfg.kv_cache_dtype == "int8":
            parts.append(da_ops.decode_attention_int8_partial(
                q, c["k"], c["v"], c["k_scale"], c["v_scale"], valid))
        else:
            parts.append(da_ops.decode_attention_partial(q, c["k"], c["v"],
                                                         valid))
    dev0 = parts[0][0].device
    acc = torch.cat([a.to(dev0) for a, _ in parts], dim=2)
    ml = torch.cat([m.to(dev0) for _, m in parts], dim=2)
    return da_ops.decode_combine(acc, ml, qs[0].dtype)


def cross_decode_attention(cfg, p, x, ck, cv, valid, *, kv_runs=None):
    """One decoder token's cross-attention over the fixed encoder memory:
    x [B,1,D]; ck/cv [B, enc_seq, KVH, hd] from
    :func:`cross_attention_cache`; valid [B, enc_seq] all true (every
    frame is attended; the caller makes it once a step).  Runs in the
    contiguous decode kernel (once a run of ``kv_runs``, as
    :func:`full_attention`'s).  Returns out [B,1,D]."""
    q = _project_q(cfg, p, x)
    out = by_runs(q, kv_runs, lambda qq, kk, vv: da_ops.decode_attention(
        qq, kk, vv, valid), ck, cv, views=True)
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


def paged_decode_attention(cfg, p, x, cache, positions, page_table, *,
                           kv_runs=None):
    """One-token decode over paged KV: x [B,1,D]; cache k/v pools
    [P,ps,KVH,hd]; positions [B] (index of the current token); page_table
    [B,N] int32 — entry n holds the pool page storing positions
    [n·ps, (n+1)·ps).  Returns out [B,1,D].

    The current token's K/V is written into page ``table[b, pos // ps]``
    at offset ``pos % ps`` **in place** on the pool tensors (the JAX
    reference donated the pool buffer and returned a new one; writing in
    place is the same without the copy).  Retired slots point every table
    entry at the scratch page 0, where their dead writes land harmlessly.
    ``kv_runs``: as :func:`full_attention`'s (the kernel then reads each
    run's KV heads of the pool in place).
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
    out = by_runs(q, kv_runs, lambda qq, kk, vv: pa_ops.paged_decode_attention(
        qq, kk, vv, page_table, lengths), cache["k"], cache["v"],
        views=True)
    return _out_proj(out, p["wo"])
