"""Encoder-decoder transformer (the Whisper backbone).

Counterpart of ``repro/models/encdec.py``.  The conv audio front end is a
stub, as in the reference: callers pass frame embeddings ``[B, enc_seq,
D]`` as ``batch["encoder_frames"]``.  Positions are sinusoidal, computed
on the fly.  Parameters keep the reference's stacked tree (``enc_layers``
and ``dec_layers``, each leaf ``[L, ...]``); layers run in a Python loop.

Every attention product runs in a kernel: the encoder's non-causal
self-attention, the decoder's causal self-attention and the prefill's
cross-attention (S query rows over ``enc_seq`` keys) in flash; a decode
step's self-attention over its contiguous cache and its cross-attention
over the encoder memory in the contiguous decode kernel (the reference
computes the cross-attention and the encoder with plain attention).
"""

from __future__ import annotations

import torch

from . import attention as att
from . import mlp as mlpmod
from .common import (PSpec, apply_norm, norm_schema, sinusoidal_positions,
                     stack_schema)
from .lm import _pick, _seq_to_cache, mask_vocab_padding


def enc_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
            "ln2": norm_schema(cfg),
            "mlp": mlpmod.mlp_schema(cfg, gated=False)}


def dec_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "self_attn": att.attn_schema(cfg),
            "ln2": norm_schema(cfg),
            "cross_attn": att.attn_schema(cfg, cross=True),
            "ln3": norm_schema(cfg),
            "mlp": mlpmod.mlp_schema(cfg, gated=False)}


def encdec_schema(cfg) -> dict:
    V, D = cfg.vocab_padded, cfg.d_model
    return {
        "embed": PSpec((V, D), "embed"),
        "enc_final_norm": norm_schema(cfg),
        "dec_final_norm": norm_schema(cfg),
        "enc_layers": stack_schema(enc_block_schema(cfg), cfg.enc_layers),
        "dec_layers": stack_schema(dec_block_schema(cfg), cfg.num_layers),
    }


def _layers(stacked, n):
    return [_pick(stacked, i) for i in range(n)]


def _logits(cfg, params, h):
    """The tied head: h @ embed^T, vocab padding masked."""
    return mask_vocab_padding(cfg, h @ params["embed"].to(h.dtype).T)


def encode(cfg, params, frames):
    """frames: [B, T_enc, D] (the stubbed conv front end's output) →
    encoder output [B, T_enc, D] in the frames' dtype."""
    B, T, D = frames.shape
    pos = torch.arange(T, dtype=torch.int32, device=frames.device)
    h = frames + sinusoidal_positions(pos, D, frames.dtype)[None]
    positions = pos[None, :].repeat(B, 1)
    for p in _layers(params["enc_layers"], cfg.enc_layers):
        h = h + att.full_attention(cfg, p["attn"],
                                   apply_norm(cfg, p["ln1"], h),
                                   positions=positions, causal=False)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], h),
                                 gated=False)
    return apply_norm(cfg, params["enc_final_norm"], h)


def dec_forward(cfg, params, tokens, enc_out, *, fill_cache=False,
                capacity=0):
    """Decoder teacher-forcing pass → (logits [B,S,V], cache or None).
    With ``fill_cache`` the cache is ``{k, v: [L, B, capacity, KVH, hd],
    cross_k, cross_v: [L, B, enc_seq, KVH, hd]}``."""
    B, S = tokens.shape
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    h = h + sinusoidal_positions(pos, cfg.d_model, h.dtype)[None]
    positions = pos[None, :].repeat(B, 1)
    caches = []
    for p in _layers(params["dec_layers"], cfg.num_layers):
        a, (k, v) = att.full_attention(
            cfg, p["self_attn"], apply_norm(cfg, p["ln1"], h),
            positions=positions, causal=True, return_kv=True)
        h = h + a
        # the encoder memory's K/V, projected once: attended here and,
        # with fill_cache, kept as the decode steps' cross cache
        cross = att.cross_attention_cache(cfg, p["cross_attn"], enc_out)
        h = h + att.full_attention(cfg, p["cross_attn"],
                                   apply_norm(cfg, p["ln2"], h),
                                   positions=positions,
                                   kv=(cross["k"], cross["v"]), causal=False)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], h),
                                 gated=False)
        if fill_cache:
            caches.append({"k": _seq_to_cache(k, capacity),
                           "v": _seq_to_cache(v, capacity),
                           "cross_k": cross["k"], "cross_v": cross["v"]})
    h = apply_norm(cfg, params["dec_final_norm"], h)
    cache = {n: torch.stack([c[n] for c in caches]) for n in caches[0]} \
        if fill_cache else None
    return _logits(cfg, params, h), cache


def forward(cfg, params, batch):
    """→ (logits [B,S,V], aux 0)."""
    enc_out = encode(cfg, params, batch["encoder_frames"])
    logits, _ = dec_forward(cfg, params, batch["tokens"], enc_out)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def init_cache(cfg, batch, capacity, device):
    """Zeroed decode cache ``{"dec": {k, v: [L, batch, capacity, KVH, hd],
    cross_k, cross_v: [L, batch, enc_seq, KVH, hd]}}``."""
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = {"k": (L, batch, capacity, KVH, hd),
              "v": (L, batch, capacity, KVH, hd),
              "cross_k": (L, batch, cfg.enc_seq, KVH, hd),
              "cross_v": (L, batch, cfg.enc_seq, KVH, hd)}
    return {"dec": {n: torch.zeros(s, dtype=cfg.activation_dtype,
                                   device=device)
                    for n, s in shapes.items()}}


def prefill(cfg, params, batch, capacity):
    """Encode the frames and run the decoder prompt → (last logits [B,V],
    cache)."""
    if capacity < batch["tokens"].shape[1]:
        raise ValueError(f"capacity {capacity} < prompt length "
                         f"{batch['tokens'].shape[1]}")
    enc_out = encode(cfg, params, batch["encoder_frames"])
    logits, cache = dec_forward(cfg, params, batch["tokens"], enc_out,
                                fill_cache=True, capacity=capacity)
    return logits[:, -1], {"dec": cache}


def decode_step(cfg, params, cache, tokens, positions):
    """tokens [B,1]; positions [B] (index of the current token) →
    (logits [B,V], cache).  The step's self-attention K/V are written into
    ``cache`` in place; the cross-attention memory is read only."""
    B = tokens.shape[0]
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    h = h + sinusoidal_positions(positions[:, None], cfg.d_model, h.dtype)
    dc = cache["dec"]
    valid = torch.ones(B, cfg.enc_seq, dtype=torch.bool, device=h.device)
    for i, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        h = h + att.decode_attention(
            cfg, p["self_attn"], apply_norm(cfg, p["ln1"], h),
            {"k": dc["k"][i], "v": dc["v"][i]}, positions)
        h = h + att.cross_decode_attention(
            cfg, p["cross_attn"], apply_norm(cfg, p["ln2"], h),
            dc["cross_k"][i], dc["cross_v"][i], valid)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], h),
                                 gated=False)
    h = apply_norm(cfg, params["dec_final_norm"], h)
    return _logits(cfg, params, h)[:, 0], cache
