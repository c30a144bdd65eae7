"""Plain PyTorch version of paged decode attention.

Naive on purpose, like the reference's oracle: gather the referenced
pages into a dense [B, N·ps] view, mask, and take a full f32 softmax, so
the kernel is checked against independently structured math.
"""

from __future__ import annotations

import torch


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths, *,
                               window=0):
    """q: [B,1,H,d]; k_pages,v_pages: [P,ps,KVH,d]; page_table: [B,N] int32;
    lengths: [B] int32 valid KV counts → [B,1,H,d].  ``window`` > 0 keeps
    keys at positions >= lengths - window."""
    B, _, H, d = q.shape
    ps, KVH = k_pages.shape[1], k_pages.shape[2]
    N = page_table.shape[1]
    G = H // KVH
    idx = page_table.long()
    k = k_pages[idx].reshape(B, N * ps, KVH, d).float()
    v = v_pages[idx].reshape(B, N * ps, KVH, d).float()
    j = torch.arange(N * ps, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = j < lens
    if window > 0:
        valid &= j >= lens - window
    qg = q[:, 0].reshape(B, KVH, G, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k) * d ** -0.5
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    # masked V rows are zeroed: stale pages may hold anything
    vz = torch.where(valid[:, :, None, None], v,
                     torch.zeros((), device=q.device))
    o = torch.einsum("bkgc,bckd->bkgd", p, vz)
    return o.reshape(B, 1, H, d).to(q.dtype)
