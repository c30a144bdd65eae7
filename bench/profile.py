"""The traced run's device timeline, summarised in memory from
``torch.profiler`` (kineto) events: the device operations with their
intervals, the ``record_function`` ranges the benchmark opens on the
host (``bench.*``) and the device spans the profiler gives them.

The busy-share arithmetic follows ``chip_smoke.py``'s ``profile_report``
(device time of the CUDA entries, the profiler's own range entries left
out), over intervals: busy is the union of the device operations'
intervals, so overlapping kernels count once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

RANGE_PREFIX = "bench."


def union(intervals):
    """Merged, sorted intervals of ``intervals`` (pairs)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def short(name: str) -> str:
    """A kernel's name without its argument list or return type."""
    head = name.split("(", 1)[0] if not name.startswith("void (") \
        else name[len("void "):].split(">(", 1)[0] + ">"
    return head.removeprefix("void ").strip()[:120]


class Timeline:
    """Device operations ``ops`` [(name, start_s, end_s)], host ranges
    ``host`` {name: sorted [(start_s, end_s)]} and the device spans of
    the ranges ``spans`` {name: [(start_s, end_s)]}; times in seconds on
    the profiler's clock."""

    def __init__(self, ops, host, spans, window_s):
        self.ops = ops
        self.host = {k: sorted(v) for k, v in host.items()}
        self.spans = spans
        self.window_s = window_s
        self.merged = union((a, b) for _, a, b in ops)

    @classmethod
    def from_profile(cls, prof, window_s):
        ops, host, spans = [], defaultdict(list), defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns() * 1e-9
            t1 = t0 + e.duration_ns() * 1e-9
            on_device = str(e.device_type()).endswith("CUDA")
            if name.startswith(RANGE_PREFIX):
                (spans if on_device else host)[name].append((t0, t1))
            elif on_device and not e.is_user_annotation():
                ops.append((name, t0, t1))
        return cls(ops, host, spans, window_s)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.merged)

    def device_ops(self, top=10):
        """[(name, seconds)] of the operations that took the most device
        time, each name cut to its function (no argument list)."""
        by = defaultdict(float)
        for name, a, b in self.ops:
            by[short(name)] += b - a
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name holds any of
        ``match``."""
        return sum(b - a for name, a, b in self.ops
                   if any(m in name for m in match))

    def seconds_inside(self, range_name) -> float:
        """Device seconds of the operations whose midpoint lies inside a
        device span of host range ``range_name``."""
        spans = union(self.spans.get(range_name, ()))
        starts = [a for a, _ in spans]
        total = 0.0
        for _, a, b in self.ops:
            mid = (a + b) / 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and mid <= spans[i][1]:
                total += b - a
        return total

    def _host_at(self, t) -> str:
        for name, ranges in self.host.items():
            i = bisect.bisect_right(ranges, (t, float("inf"))) - 1
            if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
                return name[len(RANGE_PREFIX):]
        return "runtime"

    def idle_gaps(self, top=10):
        """[(host range, seconds)]: the device's idle gaps between
        operations, summed by the benchmark's host range the host was in
        at each gap's midpoint ("runtime": none of them, i.e. the PopPy
        runtime, the dispatcher and the event loop)."""
        by = defaultdict(float)
        for (_, b), (a, _) in zip(self.merged, self.merged[1:]):
            by[self._host_at((a + b) / 2)] += a - b
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]
