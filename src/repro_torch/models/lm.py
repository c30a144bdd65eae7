"""Decoder-only language model, dense attention family.

Counterpart of the dense path of ``repro/models/lm.py``.  Parameters keep
the reference's stacked ``[L, ...]`` leaves (``params["layers"]["b0"]``);
layers run in a Python loop over that axis.  KV caches are dicts
``{"k", "v"}`` of ``[L, B, T, KVH, hd]`` tensors, paged pools
``[L, P, ps, KVH, hd]``.
"""

from __future__ import annotations

import torch

from . import attention as att
from . import mlp as mlpmod
from .common import PSpec, apply_norm, norm_schema, stack_schema

_NOT_PORTED = {
    "moe": "ROADMAP.md §A.7 (MoE)",
    "ssm": "ROADMAP.md §A.8 (recurrent families)",
    "hybrid": "ROADMAP.md §A.8 (recurrent families)",
    "enc_dec": "ROADMAP.md §A.9 (encoder-decoder)",
    "vlm": "ROADMAP.md §A.9 (pixtral patch_stub)",
}


def check_family(cfg):
    """The port runs the dense family; everything else raises naming the
    ROADMAP item that ports it."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — "
            f"{_NOT_PORTED.get(cfg.family, 'ROADMAP.md §A')}")
    if cfg.attn_window:
        raise NotImplementedError(
            f"{cfg.name}: sliding-window blocks wait for the contiguous "
            f"engine (ROADMAP.md §A.6)")


def block_schema(cfg) -> dict:
    return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlpmod.mlp_schema(cfg)}


def lm_schema(cfg) -> dict:
    check_family(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    s = {
        "embed": PSpec((V, D), "embed"),
        "final_norm": norm_schema(cfg),
        "layers": {"b0": stack_schema(block_schema(cfg), cfg.num_layers)},
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = PSpec((D, V))
    return s


def layer_params(params) -> list:
    """Per-layer views of the stacked ``[L, ...]`` block parameters."""
    stacked = params["layers"]["b0"]
    n = stacked["attn"]["wq"].shape[0]

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return [pick(stacked, i) for i in range(n)]


def embed_inputs(cfg, params, batch):
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
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


def _block(cfg, p, h, positions, **attn_kw):
    """One attention+MLP block; returns (h, (k, v) when asked)."""
    out = att.full_attention(cfg, p["attn"], apply_norm(cfg, p["ln1"], h),
                             positions=positions, **attn_kw)
    a, kv = out if attn_kw.get("return_kv") else (out, None)
    h = h + a
    h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], h))
    return h, kv


def forward(cfg, params, batch):
    """Teacher-forcing forward → (logits [B,S,V], aux_loss)."""
    check_family(cfg)
    h, positions = embed_inputs(cfg, params, batch)
    for p in layer_params(params):
        h, _ = _block(cfg, p, h, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return logits_from_hidden(cfg, params, h), aux


def init_paged_cache(cfg, num_pages, page_size, device):
    """Block-paged KV pool ``{"k", "v"}: [L, P, ps, KVH, hd]``."""
    check_family(cfg)
    pool = att.init_paged_kv_cache(cfg, num_pages, page_size,
                                   cfg.activation_dtype, device)
    return {name: leaf[None].repeat(cfg.num_layers, 1, 1, 1, 1)
            for name, leaf in pool.items()}


def decode_step_paged(cfg, params, cache, tokens, positions, page_table):
    """One decode step over block-paged KV pools: tokens [B,1], positions
    [B], page_table [B,N] int32 (shared by every layer).  Writes the
    step's K/V into ``cache`` in place and returns (logits [B,V], cache)."""
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    for i, p in enumerate(layer_params(params)):
        layer_kv = {"k": cache["k"][i], "v": cache["v"][i]}
        h = h + att.paged_decode_attention(
            cfg, p["attn"], apply_norm(cfg, p["ln1"], h), layer_kv,
            positions, page_table)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], h))
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


def prefill(cfg, params, batch, capacity, *, prefix=None, prefix_len=None,
            last_index=None):
    """Run the prompt through the model → (last_logits [B,V], cache with
    the K/V of every position, padded to ``capacity``).

    Prefix-aware mode: ``prefix`` is a cache of already-prefilled K/V
    ``[L, B, Tpad, KVH, hd]`` whose first ``prefix_len`` positions are
    valid; the batch then holds only the prompt suffix, whose positions
    start at ``prefix_len``, and the returned cache covers the suffix
    alone.  ``last_index`` selects which suffix position's logits to
    return (default: the last).
    """
    check_family(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    h, positions = embed_inputs(cfg, params, batch)
    plen = int(prefix_len or 0)
    positions = positions + plen
    ks, vs = [], []
    for i, p in enumerate(layer_params(params)):
        kw = {}
        if prefix is not None:
            kw = {"prefix_kv": (prefix["k"][i], prefix["v"][i]),
                  "prefix_len": plen}
        h, (k, v) = _block(cfg, p, h, positions, return_kv=True, **kw)
        ks.append(k)
        vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    if capacity > S:
        cache = {n: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, capacity - S)) for n, t in cache.items()}
    elif capacity < S:
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    h = apply_norm(cfg, params["final_norm"], h)
    idx = S - 1 if last_index is None else int(last_index)
    logits = logits_from_hidden(cfg, params, h[:, idx:idx + 1])
    return logits[:, 0], cache
