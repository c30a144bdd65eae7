"""Tiny shapes of every cell, for the CPU."""

TINY_RUN = {"num_layers": 2, "d_model": 64, "num_heads": 4,
            "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
            "vocab_size": 512, "vocab_padded": 512,
            # served in float32, so that a sound run's tokens are the
            # reference's whatever the CPU's timing puts in one batch
            "dtype": "float32"}
TINY_MIX = {
    "mapreduce": {"clients": 2, "fan_out": 3, "instruction_tokens": 8,
                  "doc_tokens": [40, 90], "summary_tokens": 4,
                  "summary_bytes": 6, "combine_instruction_tokens": 16,
                  "combine_tokens": 4,
                  "engine": {"max_slots": 6, "max_len": 256,
                             "page_size": 16, "prefill_chunk": 64,
                             "prefix_cache_tokens": 64},
                  "check": {"requests": 3, "served_tokens": 8}},
    "agent_loop": {"clients": 3, "turns": 3, "system_tokens": 48,
                   "task_tokens": 8, "action_tokens": 4, "action_bytes": 6,
                   "observation_tokens": 8,
                   "engine": {"max_slots": 3, "max_len": 256,
                              "page_size": 16, "prefill_chunk": 32,
                              "prefix_cache_tokens": 512},
                   "check": {"requests": 3, "served_tokens": 8}},
}


def shrink(run, mix):
    """A cell's configuration and mix at a size the CPU runs in seconds:
    every width cut, the same families, kernels' plain versions."""
    return shrink_to(run, mix)


def full_vocabulary(run, mix):
    """``shrink``, but with the cell's own vocabulary (50304 ids): most
    served ids are then no byte, as at the timed size."""
    return shrink_to(run, mix, vocab_size=run["vocab_size"],
                     vocab_padded=run["vocab_padded"])


def shrink_to(run, mix, **keep):
    run = {**run, **TINY_RUN, **keep}
    if run["family"] == "moe":
        run.update(num_experts=8, num_experts_per_tok=2,
                   moe_capacity_factor=4.0)
    return run, {**mix, **TINY_MIX[mix["name"]]}
