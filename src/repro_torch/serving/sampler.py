"""Token samplers (greedy / temperature / top-k / top-p).

Greedy is ``argmax``, as in the reference.  Stochastic draws come from an
explicit ``torch.Generator``; they follow the same distribution as the
reference's ``jax.random.categorical`` but not the same random stream.
"""

from __future__ import annotations

import torch


def filter_logits(logits, *, temperature, top_k=0, top_p=0.0):
    """The logits the draw samples from: scaled by ``temperature``, with
    everything outside the top-k / top-p set to -inf (the reference's
    masks, tie handling included)."""
    logits = logits / temperature
    V = logits.shape[-1]
    if top_k > 0:
        # top_k >= V keeps every logit, as the reference's clamped index
        kth = torch.sort(logits, dim=-1).values[:, -min(top_k, V)][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if top_p > 0.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # a cumsum that ends below top_p keeps every logit, as the
        # reference's out-of-range cutoff (NaN) does
        cutoff_idx = (cum < top_p).sum(-1).clamp(max=V - 1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _draw(logits, generator):
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_tokens(logits, *, temperature=0.0, top_k=0, top_p=0.0,
                  generator=None):
    """logits: [B, V] → tokens [B] int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    masked = filter_logits(logits, temperature=temperature, top_k=top_k,
                           top_p=top_p)
    return _draw(masked, generator).to(torch.int32)


def sample_tokens_batched(logits, temperatures, *, generator=None):
    """Mixed greedy/stochastic sampling for a whole decode batch in one
    call: logits [B, V], temperatures [B] (0 = greedy)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temperatures, min=1e-6)[:, None]
    drawn = _draw(scaled, generator).to(torch.int32)
    return torch.where(temperatures > 0.0, drawn, greedy)
