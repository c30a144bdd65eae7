"""Plain PyTorch version of the Mamba-2 SSD chunk scan.

The chunked algorithm of ``repro/models/ssd.py::ssd_chunked_ref``: per
chunk of ``chunk`` steps the causal decay matrix from a segment sum
(``-inf`` above the diagonal), the intra-chunk quadratic term, each
chunk's state, a sequential recurrence over the chunk states and the
inter-chunk term.  A ragged tail is padded with ``dt = 0``: identity decay
and no contribution, so the final state is that of the real steps.

Numerics are the Pallas wrapper's (``repro/kernels/ssd/ops.py``): ``x·dt``
and every product in float32, whatever the input dtype.  (The reference's
XLA path forms ``x·dt`` and ``C·Bᵀ`` in the activation dtype, which is the
same in a float32 model and one bf16 rounding apart in a bf16 model.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _segsum(logs):
    """logs [..., Q] → [..., Q, Q]: out[i, j] = Σ_{j<k≤i} logs[k], -inf
    above the diagonal.  Each segment is summed on its own (a cumulative
    sum down the masked columns), not as ``cum_i - cum_j``: with the
    serving model's decay ``cum`` reaches about -560 in a 256-step chunk,
    where float32 keeps only ~6e-5 of the difference."""
    Q = logs.shape[-1]
    below = torch.ones(Q, Q, dtype=torch.bool, device=logs.device).tril(-1)
    cols = logs[..., :, None].expand(*logs.shape, Q).masked_fill(~below, 0.0)
    seg = torch.cumsum(cols, dim=-2)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=logs.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def ssd_chunked_ref(xh, dt, a_log, B, C, *, chunk, initial_state=None):
    """xh [b,S,H,P]; dt [b,S,H] (post-softplus); a_log [H] (A = -exp);
    B, C [b,S,N]; initial_state [b,H,P,N] or None.
    → (y [b,S,H,P] f32, final state [b,H,P,N] f32)."""
    b, S, H, P = xh.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    dt = dt.float()
    A = -torch.exp(a_log.float())
    xdt = xh.float() * dt[..., None]                   # [b,S,H,P]
    da = dt * A                                         # [b,S,H]
    Bf, Cf = B.float(), C.float()
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    nc = (S + pad) // Q
    x_ = xdt.reshape(b, nc, Q, H, P)
    dA = da.reshape(b, nc, Q, H)
    Bc = Bf.reshape(b, nc, Q, N)
    Cc = Cf.reshape(b, nc, Q, N)

    # intra-chunk (quadratic, causal)
    L = torch.exp(_segsum(dA.transpose(2, 3)))          # [b,nc,H,Q,Q]
    scores = Cc @ Bc.transpose(-1, -2)                  # [b,nc,Q,Q]
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", L * scores[:, :, None], x_)

    # chunk states: decay-to-end weighted outer products B ⊗ x; the decay
    # to the chunk's end is a suffix sum of its own (not total - cum)
    cum = torch.cumsum(dA, dim=2)                       # [b,nc,Q,H]
    after = torch.cumsum(dA.flip(2), dim=2).flip(2)     # Σ_{k≥j}
    decay_end = torch.exp(F.pad(after[:, :, 1:], (0, 0, 0, 1)))
    states = torch.einsum("bcqn,bcqhp->bchpn", Bc,
                          x_ * decay_end[..., None])    # [b,nc,H,P,N]

    # inter-chunk recurrence over chunk states; h_in = state entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1])              # [b,nc,H]
    h = torch.zeros(b, H, P, N, dtype=torch.float32, device=xh.device) \
        if initial_state is None else initial_state.float()
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                     # [b,nc,H,P,N]

    # inter-chunk contribution: C_t · decay-from-start · h_in
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, h_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * Q, H, P)[:, :S]
    return y, h
