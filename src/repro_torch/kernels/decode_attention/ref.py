"""Plain PyTorch versions of contiguous decode attention (dense and int8
K/V), of its split-K partials and of their merge.

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


def decode_partial_ref(q, k, v, valid, chunk=None):
    """The partials of :func:`decode_attention_ref` over chunks of
    ``chunk`` cache positions (default: one chunk of all C) → (acc
    [B,H,n,d], ml [B,H,n,2]) in f32: per chunk and query head, m the max
    scaled score over the chunk's valid positions (-1e30 where it has
    none), l = Σ exp(s − m) and acc = Σ exp(s − m)·v."""
    B, _, H, d = q.shape
    C, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    chunk = C if chunk is None else int(chunk)
    n = -(-C // chunk)
    qg = q[:, 0].reshape(B, KVH, G, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k.float()) * d ** -0.5
    s = s.reshape(B, H, C)
    pad = n * chunk - C
    ok = torch.nn.functional.pad(valid, (0, pad)).view(B, 1, n, chunk)
    s = torch.nn.functional.pad(s, (0, pad)).view(B, H, n, chunk)
    s = torch.where(ok, s, torch.full((), -1e30, device=q.device))
    m = s.amax(-1)                                       # [B,H,n]
    p = torch.where(ok, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    vz = torch.where(valid[:, :, None, None], v.float(),
                     torch.zeros((), device=q.device))
    vz = torch.nn.functional.pad(vz, (0, 0, 0, 0, 0, pad))
    vz = vz.view(B, n, chunk, KVH, d)
    acc = torch.einsum("bkgnc,bnckd->bkgnd", p.view(B, KVH, G, n, chunk),
                       vz).reshape(B, H, n, d)
    return acc.contiguous(), torch.stack([m, p.sum(-1)], -1).contiguous()


def decode_partial_int8_ref(q, k_q, v_q, k_scale, v_scale, valid,
                            chunk=None):
    """:func:`decode_partial_ref` over int8 K/V, dequantized to f32."""
    k = k_q.float() * k_scale.float()[..., None]
    v = v_q.float() * v_scale.float()[..., None]
    return decode_partial_ref(q, k, v, valid, chunk)


def decode_combine_ref(acc, ml, dtype):
    """Merge partials over their n axis → [B,1,H,d] in ``dtype``; a row
    with no valid position gives 0."""
    m, l = ml[..., 0], ml[..., 1]
    mx = m.amax(-1, keepdim=True)
    c = torch.exp(m - mx)
    lsum = (l * c).sum(-1)
    o = (acc * c[..., None]).sum(2) / lsum.clamp_min(1e-30)[..., None]
    return o[:, None].to(dtype)
