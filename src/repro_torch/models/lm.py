"""Decoder-only language model: the dense attention family, the MoE
family, the VLM (a dense decoder whose prompt may start with patch
embeddings), the hybrid RG-LRU/local-attention family and the Mamba-2
SSM family.  The encoder-decoder family is :mod:`.encdec`.

Counterpart of ``repro/models/lm.py``.  Parameters keep the reference's
layer grouping: ``layers/b{i}`` holds the stacked ``[n_groups, ...]``
leaves of the i-th block of the repeating pattern (the reference's
``lax.scan`` super-blocks, e.g. RecurrentGemma's (rglru, rglru, attn)),
and ``tail{i}`` the unrolled remainder blocks; layers run in a Python loop
in that order.

Two cache layouts:
- the **paged** and **prefix-aware** path of the attention-only families
  (dense, MoE and VLM; the default engine path) keeps flat ``{"k", "v"}``
  leaves: ``[L, B, T, KVH, hd]`` from :func:`prefill`, pools ``[L, P,
  ps, KVH, hd]``;
- the **contiguous** path (SSM, hybrid, int8-KV and windowed models,
  whose state cannot be cut by position) keeps the reference's grouped tree
  (:func:`init_cache`): ``{"layers": {"b{i}": leaves [n_groups, B, ...]},
  "tail{i}": leaves [B, ...]}``, with windowed attention in ring buffers
  of ``min(capacity, window)`` slots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import attention as att
from . import mlp as mlpmod
from . import moe as moemod
from . import rglru as rgmod
from . import ssd as ssdmod
from .common import PSpec, apply_norm, norm_schema, stack_schema

# families whose every block is global attention plus a feed-forward
ATTENTION_ONLY = ("dense", "moe", "vlm")


def check_family(cfg):
    """This module runs the decoder-only families; the encoder-decoder
    family runs in :mod:`.encdec`, and any other family raises."""
    if cfg.family not in ATTENTION_ONLY + ("hybrid", "ssm"):
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} has no decoder-only LM"
            + (" (encoder-decoder models run in models.encdec)"
               if cfg.family == "enc_dec" else ""))


def is_contiguous(cfg) -> bool:
    """True when the serving cache cannot be cut by position (recurrent
    state, ring buffers, int8 KV): such models use the grouped contiguous
    cache and exact-length prefill."""
    return (cfg.family not in ATTENTION_ONLY
            or cfg.kv_cache_dtype == "int8" or bool(cfg.attn_window))


# ---------------------------------------------------------------------------
# layer grouping and schemas


def block_kinds(cfg) -> list:
    """The per-layer block kinds, in order."""
    check_family(cfg)
    if cfg.family in ("dense", "vlm"):
        return ["attn_mlp"] * cfg.num_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["ssd"] * cfg.num_layers
    pat = list(cfg.block_pattern)
    kinds = []
    while len(kinds) < cfg.num_layers:
        kinds.extend(pat)
    return [("rglru_mlp" if k == "rglru" else "attn_mlp_local")
            for k in kinds[:cfg.num_layers]]


def _layer_groups(cfg):
    """(group_kinds, n_groups, tail_kinds): n_groups super-blocks of
    group_kinds, then the unrolled tail_kinds."""
    kinds = block_kinds(cfg)
    if cfg.family == "hybrid":
        pat_len = len(cfg.block_pattern)
        n_groups = cfg.num_layers // pat_len
        return kinds[:pat_len], n_groups, kinds[n_groups * pat_len:]
    return [kinds[0]], cfg.num_layers, []


def block_schema(cfg, kind: str) -> dict:
    if kind in ("attn_mlp", "attn_mlp_local"):
        return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
                "ln2": norm_schema(cfg), "mlp": mlpmod.mlp_schema(cfg)}
    if kind == "attn_moe":
        return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
                "ln2": norm_schema(cfg), "moe": moemod.moe_schema(cfg)}
    if kind == "rglru_mlp":
        return {"ln1": norm_schema(cfg), "rglru": rgmod.rglru_schema(cfg),
                "ln2": norm_schema(cfg), "mlp": mlpmod.mlp_schema(cfg)}
    if kind == "ssd":   # pre-norm only: no MLP after the mixer
        return {"ln1": norm_schema(cfg), "ssd": ssdmod.ssd_schema(cfg)}
    raise ValueError(kind)


def lm_schema(cfg) -> dict:
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    group = {f"b{i}": block_schema(cfg, k) for i, k in enumerate(group_kinds)}
    s = {
        "embed": PSpec((V, D), "embed"),
        "final_norm": norm_schema(cfg),
        "layers": stack_schema(group, n_groups),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = PSpec((D, V))
    for i, k in enumerate(tail_kinds):
        s[f"tail{i}"] = block_schema(cfg, k)
    return s


def _pick(tree, i):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def blocks(cfg, tree):
    """(kind, subtree) of every layer in order, where ``tree`` is the
    parameter tree or a grouped cache: layer g·P + i of the super-blocks
    reads ``tree["layers"]["b{i}"]`` at index g (views, so an in-place
    cache update writes through), then the tail blocks."""
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    out = []
    for g in range(n_groups):
        for i, kind in enumerate(group_kinds):
            out.append((kind, _pick(tree["layers"][f"b{i}"], g)))
    for i, kind in enumerate(tail_kinds):
        out.append((kind, tree[f"tail{i}"]))
    return out


# ---------------------------------------------------------------------------
# embeddings and logits


def embed_inputs(cfg, params, batch):
    """Token embeddings and positions.  A ``patch_stub`` model (the VLM)
    given ``batch["patch_embeds"]`` [B, n, D] takes them in place of the
    first n token embeddings; positions stay 0 … S-1."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    if cfg.frontend == "patch_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :].repeat(B, 1)
    return h, positions


def mask_vocab_padding(cfg, logits):
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    return torch.where(pad, logits, torch.full((), -1e30, dtype=logits.dtype,
                                               device=logits.device))


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    return mask_vocab_padding(cfg, logits)


# ---------------------------------------------------------------------------
# full sequence (forward and prefill)


def _window(cfg, kind):
    return cfg.attn_window if kind == "attn_mlp_local" else 0


# recurrent block kinds → (parameter subtree, full-sequence function)
_RECURRENT = {"rglru_mlp": ("rglru", rgmod.apply_rglru),
              "ssd": ("ssd", ssdmod.apply_ssd)}


def feed_forward(cfg, kind, p, h):
    """The block's second half: h + FFN(norm(h)) → (h, the MoE layer's
    Switch aux loss, or None for an MLP)."""
    x = apply_norm(cfg, p["ln2"], h)
    if kind == "attn_moe":
        m, aux = moemod.apply_moe(cfg, p["moe"], x)
        return h + m, aux
    return h + mlpmod.apply_mlp(cfg, p["mlp"], x), None


def apply_block(cfg, kind, p, h, positions, *, fill=None, return_kv=False,
                prefix_kv=None, prefix_len=0):
    """One block over a full sequence → (h, cache, aux).  With ``fill`` (a
    cache capacity) the cache is the block's decode cache: packed K/V
    placed in ``min(fill, window)`` slots for attention, the final state
    for RG-LRU and SSD.  With ``return_kv`` it is an attention block's raw
    (k, v); ``prefix_kv``/``prefix_len`` are prefix-aware prefill's
    (see :func:`att.full_attention`).  Otherwise it is None.  ``aux`` is
    an MoE block's Switch aux loss, else None."""
    x = apply_norm(cfg, p["ln1"], h)
    cache = None
    if kind in _RECURRENT:
        name, apply = _RECURRENT[kind]
        out = apply(cfg, p[name], x, return_state=fill is not None)
        mix, cache = out if fill is not None else (out, None)
    else:
        window = _window(cfg, kind)
        mix, kv = att.full_attention(
            cfg, p["attn"], x, positions=positions, window=window,
            return_kv=True, prefix_kv=prefix_kv, prefix_len=prefix_len)
        if fill is not None:
            cap = min(fill, window) if window else fill
            cache = {n: _seq_to_cache(leaf, cap)
                     for n, leaf in att.pack_kv(cfg, *kv).items()}
        elif return_kv:
            cache = kv
    h = h + mix
    if kind == "ssd":   # pre-norm only: no feed-forward after the mixer
        return h, cache, None
    h, aux = feed_forward(cfg, kind, p, h)
    return h, cache, aux


def forward(cfg, params, batch):
    """Teacher-forcing forward → (logits [B,S,V], aux_loss: the sum of
    the MoE layers' Switch losses, 0 without MoE layers)."""
    h, positions = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, p in blocks(cfg, params):
        h, _, a = apply_block(cfg, kind, p, h, positions)
        if a is not None:
            aux = aux + a
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h), aux


def _seq_to_cache(kv, capacity):
    """Place [B,S,...] K/V into a capacity-sized cache buffer (ring
    semantics when capacity < S: keep the last ``capacity`` positions at
    slots pos % capacity)."""
    S = kv.shape[1]
    if capacity == S:
        return kv
    if capacity > S:
        pad = kv.new_zeros((kv.shape[0], capacity - S) + kv.shape[2:])
        return torch.cat([kv, pad], dim=1)
    tail = kv[:, S - capacity:]
    return torch.roll(tail, shifts=(S - capacity) % capacity, dims=1)


def prefill(cfg, params, batch, capacity, *, prefix=None, prefix_len=None,
            last_index=None):
    """Run the prompt through the model → (last_logits [B,V], cache).

    Contiguous models (:func:`is_contiguous`): the grouped cache of
    :func:`init_cache` at ``capacity``, filled from the prompt (attention
    K/V packed and placed in ring slots, RG-LRU and SSD final states with
    their conv histories).

    Dense/MoE models: flat ``{"k", "v"}: [L, B, capacity, KVH, hd]``.  In
    prefix-aware mode ``prefix`` holds already-prefilled K/V ``[L, B,
    Tpad, KVH, hd]`` whose first ``prefix_len`` positions are valid; the
    batch then holds only the prompt suffix, whose positions start at
    ``prefix_len``, and the returned cache covers the suffix alone.
    ``last_index`` selects which position's logits to return (default:
    the last)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if capacity < S and any(k in ("attn_mlp", "attn_moe")
                            for k in block_kinds(cfg)):
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    h, positions = embed_inputs(cfg, params, batch)
    plen = int(prefix_len or 0)
    positions = positions + plen
    if is_contiguous(cfg):
        if prefix is not None:
            raise ValueError(f"{cfg.name}: prefix-aware prefill needs a "
                             f"positionally sliceable cache")
        caches = []
        for kind, p in blocks(cfg, params):
            h, c, _ = apply_block(cfg, kind, p, h, positions,
                                  fill=capacity)
            caches.append(c)
        cache = _group_caches(cfg, caches)
    else:
        ks, vs = [], []
        for i, (kind, p) in enumerate(blocks(cfg, params)):
            kw = {}
            if prefix is not None:
                kw = {"prefix_kv": (prefix["k"][i], prefix["v"][i]),
                      "prefix_len": plen}
            h, (k, v), _ = apply_block(cfg, kind, p, h, positions,
                                       return_kv=True, **kw)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if capacity > S:
            cache = {n: F.pad(t, (0, 0, 0, 0, 0, capacity - S))
                     for n, t in cache.items()}
    h = apply_norm(cfg, params["final_norm"], h)
    idx = S - 1 if last_index is None else int(last_index)
    logits = logits_from_hidden(cfg, params, h[:, idx:idx + 1])
    return logits[:, 0], cache


def _group_caches(cfg, caches):
    """Per-layer caches, in layer order → the grouped cache tree."""
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    P = len(group_kinds)
    out = {"layers": {
        f"b{i}": {n: torch.stack([caches[g * P + i][n]
                                  for g in range(n_groups)])
                  for n in caches[i]}
        for i in range(P)}}
    for i in range(len(tail_kinds)):
        out[f"tail{i}"] = caches[n_groups * P + i]
    return out


# ---------------------------------------------------------------------------
# contiguous cache and decode


def block_cache(cfg, kind, batch, capacity, dtype, device):
    if kind == "rglru_mlp":
        return rgmod.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "ssd":
        return ssdmod.init_ssd_cache(cfg, batch, dtype, device)
    window = _window(cfg, kind)
    cap = min(capacity, window) if window else capacity
    return att.init_kv_cache(cfg, batch, cap, dtype, device)


def init_cache(cfg, batch, capacity, device):
    """Grouped contiguous cache mirroring the layer grouping: leaves
    ``[n_groups, batch, ...]`` under ``layers/b{i}``, ``[batch, ...]``
    under ``tail{i}``."""
    dtype = cfg.activation_dtype
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    cache = {"layers": {
        f"b{i}": {n: leaf[None].repeat((n_groups,) + (1,) * leaf.dim())
                  for n, leaf in block_cache(cfg, k, batch, capacity, dtype,
                                             device).items()}
        for i, k in enumerate(group_kinds)}}
    for i, k in enumerate(tail_kinds):
        cache[f"tail{i}"] = block_cache(cfg, k, batch, capacity, dtype,
                                        device)
    return cache


def decode_block(cfg, kind, p, h, cache, positions):
    """One block of one decode step; updates ``cache`` in place."""
    x = apply_norm(cfg, p["ln1"], h)
    if kind == "ssd":
        return h + ssdmod.decode_ssd(cfg, p["ssd"], x, cache)
    if kind == "rglru_mlp":
        h = h + rgmod.decode_rglru(cfg, p["rglru"], x, cache)
    else:
        h = h + att.decode_attention(cfg, p["attn"], x, cache, positions,
                                     window=_window(cfg, kind))
    return feed_forward(cfg, kind, p, h)[0]


def decode_step(cfg, params, cache, tokens, positions):
    """One decode step over the grouped contiguous cache: tokens [B,1],
    positions [B] (index of the current token).  Updates ``cache`` in
    place and returns (logits [B,V], cache)."""
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    for (kind, p), (_, c) in zip(blocks(cfg, params), blocks(cfg, cache)):
        h = decode_block(cfg, kind, p, h, c, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# paged decode (dense and MoE families, block-paged KV pools)


def init_paged_cache(cfg, num_pages, page_size, device):
    """Block-paged KV pool ``{"k", "v"}: [L, P, ps, KVH, hd]``."""
    if is_contiguous(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires uniform global "
                         f"attention with unquantized KV")
    pool = att.init_paged_kv_cache(cfg, num_pages, page_size,
                                   cfg.activation_dtype, device)
    return {name: leaf[None].repeat(cfg.num_layers, 1, 1, 1, 1)
            for name, leaf in pool.items()}


def decode_step_paged(cfg, params, cache, tokens, positions, page_table):
    """One decode step over block-paged KV pools: tokens [B,1], positions
    [B], page_table [B,N] int32 (shared by every layer).  Writes the
    step's K/V into ``cache`` in place and returns (logits [B,V], cache)."""
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    for i, (kind, p) in enumerate(blocks(cfg, params)):
        layer_kv = {"k": cache["k"][i], "v": cache["v"][i]}
        h = h + att.paged_decode_attention(
            cfg, p["attn"], apply_norm(cfg, p["ln1"], h), layer_kv,
            positions, page_table)
        h = feed_forward(cfg, kind, p, h)[0]
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)[:, 0], cache
