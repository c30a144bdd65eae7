"""Share of its roofline that the paged decode attention kernel reached
over the profiled tail: the least time the card could take for every
decode step's attention there (``flops.paged_decode_bound_s``, from the
context lengths each step's active slots attended) ÷ the device time of
the kernel's functions there, in %."""

from bench import flops

FUNCS = ("paged_mma_kernel", "paged_decode_kernel", "decode_combine_kernel")


def read(obs):
    if obs.timeline is None:
        return None
    a, b = obs.host_window[1], obs.window[1]
    bound = sum(flops.paged_decode_bound_s(obs.run, ctx)
                for t, ctx in obs.steps if a <= t <= b and ctx)
    spent = obs.timeline.op_seconds(FUNCS)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
