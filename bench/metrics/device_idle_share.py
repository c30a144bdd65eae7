"""1 - the union of the device operations' intervals ÷ the profiled
tail's length (``torch.profiler``)."""


def read(obs):
    tl = obs.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 1.0 - tl.busy_s / tl.window_s
