"""Plain PyTorch version of flash attention with an optional padded prefix."""

from __future__ import annotations

import torch


def keep_mask(S, T, *, causal=True, window=0, prefix_pad=0, prefix_len=0,
              device=None):
    """[S, T] boolean: query i keeps key j iff j < prefix_len, or
    j >= prefix_pad and (causal ⇒ j - prefix_pad <= i) and
    (window ⇒ j - prefix_pad > i - window).  With no prefix this is the
    reference kernel's causal/window mask."""
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    rel = j - prefix_pad
    own = (j >= prefix_pad) & torch.ones(S, 1, dtype=torch.bool,
                                         device=device)
    if causal:
        own = own & (rel <= i)
    if window > 0:
        own = own & (rel > i - window)
    return own | (j < prefix_len)


def flash_attention_ref(q, k, v, *, causal=True, window=0, prefix_pad=0,
                        prefix_len=0):
    """q: [B,S,H,d]; k,v: [B,T,KVH,d] (the first ``prefix_pad`` rows a
    padded prefix whose first ``prefix_len`` are valid) → [B,S,H,d];
    f32 softmax."""
    B, S, H, d = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    keep = keep_mask(S, T, causal=causal, window=window,
                     prefix_pad=prefix_pad, prefix_len=prefix_len,
                     device=q.device)
    qg = q.reshape(B, S, KVH, G, d).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * d ** -0.5
    s = torch.where(keep, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    # prefix padding rows are never attended: zero them so whatever they
    # hold cannot reach the output through 0 * value
    pad = (torch.arange(T, device=q.device) >= prefix_len) \
        & (torch.arange(T, device=q.device) < prefix_pad)
    vz = torch.where(pad[None, :, None, None], torch.zeros((), device=q.device),
                     v.float())
    o = torch.einsum("bkgst,btkd->bskgd", p, vz)
    return o.reshape(B, S, H, d).to(q.dtype)
