"""Share of its roofline that the flash prefill kernel reached over the
profiled tail: the least time the card could take for every prefill
chunk's attention there (``flops.flash_prefill_bound_s``, from each
chunk's tokens and cached prefix) ÷ the kernel's device time there,
in %."""

from bench import flops

FUNCS = ("flash_mma_kernel", "flash_fwd_kernel")


def read(obs):
    if obs.timeline is None:
        return None
    a, b = obs.host_window[1], obs.window[1]
    bound = sum(flops.flash_prefill_bound_s(obs.run, n, prefix)
                for t, n, prefix, _ in obs.chunks if a <= t <= b)
    spent = obs.timeline.op_seconds(FUNCS)
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
