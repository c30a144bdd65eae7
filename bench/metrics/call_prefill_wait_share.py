"""Share of the requests' time spent waiting behind other tasks' prefill
chunks: the engine's ``prefill_wait_s`` (admit → first chunk) ÷ the sum
of its four lifecycle counters (queued, that wait, prefilling, decoding),
over the requests finished in the host window."""

PARTS = ("queue_wait_s", "prefill_wait_s", "prefill_s", "decode_s")


def read(obs):
    parts = [obs.engine.get(k) for k in PARTS]
    if None in parts or sum(parts) <= 0:
        return None
    return obs.engine["prefill_wait_s"] / sum(parts)
