"""Device time inside the MoE layer (the ``bench.moe`` range around
``models.moe.apply_moe``) ÷ device time inside prefill chunks, over the
profiled tail.  Decode steps replay a CUDA graph, which carries no host
range, so the decode step's MoE share is not read here."""


def read(obs):
    tl = obs.timeline
    if tl is None:
        return None
    chunks = tl.seconds_inside("bench.prefill_chunk")
    moe = tl.seconds_inside("bench.moe")
    if chunks <= 0 or moe <= 0:
        return None
    return moe / chunks
