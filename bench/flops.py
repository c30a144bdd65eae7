"""The yardstick's work counts and the card's peaks, kept with the
benchmark so that a change to the program cannot move them.

- Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16,
  3.35 TB/s HBM3).
- ``matmul_params``: the weights a token's forward multiplies by (the
  MoE layer's router and its k experts alone), counted from the
  configuration's ``run`` block; ``mfu`` counts 2 FLOP a weight a token.
- Attention: 4·head_dim FLOP a (query head, attended key) pair (QKᵀ and
  PV); bytes as each input is read once and each output written once
  (``paged_decode_attention_work`` and ``flash_attention_work`` of the
  port count the same way, but over the padded shapes the kernels
  launch; these count the positions the requests need).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def matmul_params(run: dict, *, with_head=True) -> int:
    """Weights a token's forward multiplies by, per token."""
    D, H, KVH, hd = (run["d_model"], run["num_heads"], run["num_kv_heads"],
                     run["head_dim"])
    F = run["d_ff"]
    attn = D * (H + 2 * KVH) * hd + H * hd * D
    if run["family"] == "moe":
        ffn = D * run["num_experts"] + run["num_experts_per_tok"] * 3 * D * F
    else:
        ffn = 3 * D * F
    head = D * run["vocab_size"] if with_head else 0
    return run["num_layers"] * (attn + ffn) + head


def attn_flops(run: dict, pairs: int) -> float:
    """QKᵀ and PV over ``pairs`` (query position, key position) pairs,
    every head of every layer."""
    return 4.0 * run["head_dim"] * run["num_heads"] * run["num_layers"] \
        * pairs


def chunk_pairs(n: int, prefix: int) -> int:
    """Causal pairs of an ``n``-token chunk after ``prefix`` positions."""
    return n * prefix + n * (n + 1) // 2


def prefill_chunk_flops(run: dict, n: int, prefix: int) -> float:
    """Model FLOP of one prefill chunk: every token through the layers,
    the logits of its last position alone (the engine's ``last_index``)."""
    return 2.0 * (n * matmul_params(run, with_head=False)
                  + run["d_model"] * run["vocab_size"]) \
        + attn_flops(run, chunk_pairs(n, prefix))


def decode_step_flops(run: dict, contexts) -> float:
    """Model FLOP of one decode step whose active slots attend
    ``contexts`` keys each (the new token's included)."""
    return 2.0 * len(contexts) * matmul_params(run) \
        + attn_flops(run, sum(contexts))


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes at peak bandwidth or
    operations at the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def paged_decode_bound_s(run: dict, contexts) -> float:
    """Every layer's paged decode attention over the active slots: K and
    V of each attended position read once, q read and the output
    written once."""
    H, KVH, hd, L = (run["num_heads"], run["num_kv_heads"], run["head_dim"],
                     run["num_layers"])
    n = len(contexts)
    nbytes = L * BF16 * hd * (2 * KVH * sum(contexts) + 2 * H * n)
    return bound_s(nbytes, attn_flops(run, sum(contexts)))


def flash_prefill_bound_s(run: dict, n: int, prefix: int) -> float:
    """Every layer's flash attention over one chunk of ``n`` queries
    after ``prefix`` cached positions: q and the output once, K and V of
    the ``prefix + n`` keys once."""
    H, KVH, hd, L = (run["num_heads"], run["num_kv_heads"], run["head_dim"],
                     run["num_layers"])
    nbytes = L * BF16 * hd * (2 * H * n + 2 * KVH * (prefix + n))
    return bound_s(nbytes, attn_flops(run, chunk_pairs(n, prefix)))
