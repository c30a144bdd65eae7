"""The whole step's share of the card's bf16 peak over the host window:
model FLOP of the tokens processed there (every prefill chunk's tokens,
the decode steps' active slots alone; ``flops.prefill_chunk_flops`` and
``flops.decode_step_flops``) ÷ (the host window's seconds × 989 TFLOP/s),
in %."""

from bench import flops


def read(obs):
    a, b = obs.host_window
    work = sum(flops.prefill_chunk_flops(obs.run, n, prefix)
               for t, n, prefix, _ in obs.chunks if a <= t <= b)
    work += sum(flops.decode_step_flops(obs.run, ctx)
                for t, ctx in obs.steps if a <= t <= b and ctx)
    if work <= 0:
        return None
    return 100.0 * work / ((b - a) * flops.PEAK_BF16_FLOPS)
