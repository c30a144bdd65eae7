"""Mean device time of a prefill chunk over the host window: a CUDA
event pair around each ``ServingEngine._run_prefill`` in the traced
run."""


def read(obs):
    a, b = obs.host_window
    times = [s for t, _, _, s in obs.chunks if a <= t <= b and s is not None]
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
