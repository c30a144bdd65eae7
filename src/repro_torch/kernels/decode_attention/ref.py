"""Plain PyTorch versions of contiguous decode attention (dense and int8
K/V).

Naive on purpose, like the reference's oracle: one f32 softmax over the
whole cache length, so the kernel's split-K online softmax is checked
against independently structured math.  Invalid V rows are zeroed before
``p @ v``, as the kernel's contract says: a NaN in an unwritten or stale
slot cannot reach the output.
"""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, valid):
    """q: [B,1,H,d]; k,v: [B,C,KVH,d]; valid: [B,C] bool → [B,1,H,d] in
    q's dtype.  Query head h attends kv head h // (H / KVH)."""
    B, _, H, d = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qg = q[:, 0].reshape(B, KVH, G, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k.float()) * d ** -0.5
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    vz = torch.where(valid[:, :, None, None], v.float(),
                     torch.zeros((), device=q.device))
    o = torch.einsum("bkgc,bckd->bkgd", p, vz)
    return o.reshape(B, 1, H, d).to(q.dtype)


def decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale, valid):
    """The same over int8 K/V ``[B,C,KVH,d]`` with f32 scales ``[B,C,KVH]``,
    dequantized to f32 first."""
    k = k_q.float() * k_scale.float()[..., None]
    v = v_q.float() * v_scale.float()[..., None]
    return decode_attention_ref(q, k, v, valid)
