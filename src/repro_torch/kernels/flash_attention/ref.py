"""Plain PyTorch version of flash attention with an optional padded prefix."""

from __future__ import annotations

import torch


def keep_mask(S, T, *, causal=True, window=0, prefix_pad=0, prefix_len=0,
              device=None):
    """[S, T] boolean: query i, at position prefix_len + i, keeps key j
    iff j < prefix_len and (window ⇒ j > prefix_len + i - window), or
    j >= prefix_pad and (causal ⇒ j - prefix_pad <= i) and
    (window ⇒ j - prefix_pad > i - window).  With no prefix this is the
    reference kernel's causal/window mask; with ``prefix_pad = prefix_len
    = r·S`` it is the reference's mask over shard r's rows of a sequence
    split over the model axis."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    rel = j - prefix_pad
    own = (j >= prefix_pad) & torch.ones(S, 1, dtype=torch.bool,
                                         device=device)
    pre = j < prefix_len
    if causal:
        own = own & (rel <= i)
    if window > 0:
        own = own & (rel > i - window)
        pre = pre & (j > prefix_len + i - window)
    return own | pre


def flash_attention_ref(q, k, v, *, causal=True, window=0, prefix_pad=0,
                        prefix_len=0):
    """q: [B,S,H,d]; k,v: [B,T,KVH,d] (the first ``prefix_pad`` rows a
    padded prefix whose first ``prefix_len`` are valid) → [B,S,H,d];
    f32 softmax (f64 for f64 inputs, which gradient checks use)."""
    B, S, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    keep = keep_mask(S, T, causal=causal, window=window,
                     prefix_pad=prefix_pad, prefix_len=prefix_len,
                     device=q.device)
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, S, KVH, G, d).to(acc)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc)) * d ** -0.5
    s = torch.where(keep, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    # prefix padding rows are never attended: zero them so whatever they
    # hold cannot reach the output through 0 * value
    pad = (torch.arange(T, device=q.device) >= prefix_len) \
        & (torch.arange(T, device=q.device) < prefix_pad)
    vz = torch.where(pad[None, :, None, None], torch.zeros((), device=q.device),
                     v.to(acc))
    o = torch.einsum("bkgst,btkd->bskgd", p, vz)
    return o.reshape(B, S, H, d).to(q.dtype)
