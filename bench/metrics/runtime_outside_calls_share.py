"""Share of a program's wall time in which none of its external calls was
in flight, averaged over the programs completed in the host window.  The
interval arithmetic is a copy of ``chip_smoke.py::externals_idle_s``."""

import math


def externals_idle_s(spans, wall_s):
    covered, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return max(wall_s - covered, 0.0)


def read(obs):
    done = obs.programs_done_in(*obs.host_window)
    if not done:
        return None
    return sum(externals_idle_s(p.externals, p.t_end - p.t_start)
               / (p.t_end - p.t_start) for p in done) / len(done)
