"""Median latency, start to return, of every program completed in the
window (host clock)."""

import statistics


def read(obs):
    done = obs.programs_done_in(*obs.window)
    if not done:
        return None
    return statistics.median(p.t_end - p.t_start for p in done)
