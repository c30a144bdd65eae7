"""What decides ``correct``: the served tokens against the plain
reference, and the programs against plain sequential Python.

The model check takes a sample, drawn from the seed, of the requests the
window served (the longest among them), runs the reference once over
each prompt with its served tokens, and reads at every served position
the gap by which the served token's logit lies below the reference's
best.  The numbers are the widest such gap and the mean gap over the
served positions; a cell's limits file names the ones it compares.  The
control reads, at the same positions, the gap of the token that the fp8
reference puts first.

Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference


def sample_requests(requests, seed: int, *, count: int, served: int):
    """Up to ``count`` requests: the longest (prompt and served tokens),
    then others drawn from the seed until ``served`` tokens are covered.
    ``requests`` is a list of (prompt tokens, served tokens)."""
    if not requests:
        return []
    order = sorted(range(len(requests)),
                   key=lambda i: (-(len(requests[i][0])
                                    + len(requests[i][1])), i))
    rng = np.random.default_rng([int(seed) % (1 << 64), 7])
    rest = [order[0]] + [order[1:][j] for j in
                         rng.permutation(len(order) - 1)]
    picked, tokens = [], 0
    for i in rest:
        if len(picked) >= count or (tokens >= served and picked):
            break
        picked.append(i)
        tokens += len(requests[i][1])
    return [requests[i] for i in picked]


def rows_of(prompt, served):
    """Positions whose logits chose the served tokens: the prompt's last,
    then each served token's but the last."""
    return list(range(len(prompt) - 1, len(prompt) + len(served) - 1))


def gaps(ref_logits, tokens):
    """max(ref) - ref[token] at each row, ``tokens`` a [rows] long tensor;
    a token outside the vocabulary reads +inf."""
    V = ref_logits.shape[-1]
    best = ref_logits.max(-1).values
    inside = tokens < V
    got = ref_logits.gather(-1, tokens.clamp(max=V - 1)[:, None])[:, 0]
    return torch.where(inside, best - got,
                       torch.full_like(best, float("inf")))


def model_readings(run, tree, requests, *, control=False):
    """Over ``requests``: the widest served-token gap (``gap``) and the
    mean over every served position (``mean_gap``); with ``control``, the
    same two of the fp8 reference's first token at the same positions
    (``control_gap``, ``control_mean_gap``).  → those and ``tokens``."""
    got, ctl_got = [], []
    for prompt, served in requests:
        tokens = list(prompt) + list(served[:-1])
        rows = rows_of(prompt, served)
        ref = reference.logits_at(run, tree, tokens, rows)
        want = torch.as_tensor(served, dtype=torch.long, device=ref.device)
        got.append(gaps(ref, want).cpu())
        if control:
            ctl = reference.logits_at(run, tree, tokens, rows, quant="fp8")
            ctl_got.append(gaps(ref, ctl.argmax(-1)).cpu())
            del ctl
        del ref
    if not got:
        return {"gap": None, "mean_gap": None, "tokens": 0}
    g = torch.cat(got)
    out = {"gap": float(g.max()), "mean_gap": float(g.mean()),
           "tokens": int(g.numel())}
    if control:
        c = torch.cat(ctl_got)
        out["control_gap"] = float(c.max())
        out["control_mean_gap"] = float(c.mean())
    return out


def verdict(readings: dict, limits: dict):
    """(correct, lines): every number beside its limit; a number passes
    when it is at most its limit."""
    lines, ok = {}, True
    for name, value in readings.items():
        limit = limits[name]
        lines[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    return ok, lines
