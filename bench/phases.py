"""The engine's own tracing, read in a run of a cell: the call-lifecycle
counters over the host window, and the program's spans
(``repro_torch.obs``) mapped onto the profiler's clock by the tracer's
anchor, for the four per-layer readings that need them
(``metrics/call_prefill_wait_share``, ``prefill_chunk_device_ms``,
``prefill_forward_idle_share`` and ``decode_host_idle_share``).

    python3 bench/phases.py --workload <cell> --seed <n> --seconds <s> \\
        --trace 1

runs the cell once as ``bench/run.py`` does and prints its result line
with those readings.  It adds to the harness, in this process only, the
lines that carrying the readings into ``bench/run.py`` takes; this file
goes once they are there (ROADMAP F.8):

- ``harness.engine_counters`` also returns the engine's lifecycle
  counters, so that they are diffed over the host window;
- once the profiler has started, an anchored ``repro_torch.obs.Tracer``
  is switched on process-wide; it is switched off before the profiler
  stops, then resolved (each ``prefill.chunk`` span's ``device_ms``);
- the timeline (:class:`PhaseTimeline`) also holds the program's spans of
  the profiled tail on the profiler's clock;
- the cell's ``per_layer`` list takes the four entries of ``METRICS``.

Against a program without these spans and counters the readers return
nothing.  Needs a CUDA device, as ``bench/run.py`` does.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench.profile import Timeline, union  # noqa: E402

LIFECYCLE = ("queue_wait_s", "prefill_wait_s", "prefill_s", "decode_s")
# the per-layer entries that reading these in bench/run.py would add
METRICS = [
    {"name": "call_prefill_wait_share", "unit": "share", "better": "lower",
     "source": "program_counter",
     "layer": "engine scheduler (serving/engine.py)",
     "moves": "call_p95_s"},
    {"name": "prefill_chunk_device_ms", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "model step (models)",
     "moves": "program_p50_s"},
    {"name": "prefill_forward_idle_share", "unit": "share",
     "better": "lower", "source": "device_trace",
     "layer": "model step (models)", "moves": "program_p50_s"},
    {"name": "decode_host_idle_share", "unit": "share", "better": "lower",
     "source": "device_trace",
     "layer": "engine scheduler, decode graph", "moves": "programs_per_s"},
]


def covers(intervals, t) -> bool:
    """``t`` lies in one of the sorted, disjoint ``intervals``."""
    i = bisect.bisect_right(intervals, [t, float("inf")]) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


class PhaseTimeline(Timeline):
    """A :class:`~bench.profile.Timeline` that also holds the program's
    spans ``program`` [(name, start_s, end_s, span)] on the profiler's
    clock."""

    program = ()

    @classmethod
    def from_profile(cls, prof, window_s):
        tl = super().from_profile(prof, window_s)
        trz = getattr(prof, "poppy_tracer", None)
        if trz is not None:
            tl.attach(trz, anchor_starts(prof), prof.poppy_off_t)
        return tl

    def attach(self, trz, starts, off_t):
        """The tracer's spans closed between its anchor and ``off_t``
        (tracer time), put on the profiler's clock by the starts of its
        anchor ranges there; none without them."""
        shift = trz.profiler_offset(starts)
        if shift is None:
            return
        self.program = [(s.name, s.t0 + shift, s.t1 + shift, s)
                        for s in trz.closed_spans()
                        if trz.anchors[-1] <= s.t0 and s.t1 <= off_t]

    def spans_named(self, name):
        return [(a, b, s) for n, a, b, s in self.program if n == name]

    def idle_in(self, names, outside=()) -> float:
        """Seconds of the device's idle gaps whose midpoint lies in a
        program span named in ``names`` and in none named in ``outside``
        (the midpoint rule of :meth:`Timeline.idle_gaps`)."""
        inside = union((a, b) for n, a, b, _ in self.program if n in names)
        out = union((a, b) for n, a, b, _ in self.program if n in outside)
        total = 0.0
        for (_, b), (a, _) in zip(self.merged, self.merged[1:]):
            mid = (a + b) / 2
            if covers(inside, mid) and not covers(out, mid):
                total += a - b
        return total


def anchor_starts(prof):
    """Starts (s, the profiler's clock) of a profile's ``poppy.anchor``
    ranges."""
    from repro_torch.obs.spans import ANCHOR
    return [e.start_ns() * 1e-9 for e in prof.profiler.kineto_results.events()
            if e.name() == ANCHOR]


def install(harness, profile_mod, torch):
    """Add the lines above to the harness for this process; → the state
    the run leaves behind (the tail's tracer and timeline)."""
    from repro_torch.obs import Tracer, set_process_tracer
    seen = {"tracer": None, "timeline": None}
    counters = harness.engine_counters

    def engine_counters(engine):
        out = dict(counters(engine))
        for k in LIFECYCLE + ("requests_finished",):
            if hasattr(engine, k):
                out[k] = getattr(engine, k)
        return out
    harness.engine_counters = engine_counters

    class Profile(torch.profiler.profile):
        def start(self):
            super().start()
            self.poppy_tracer = seen["tracer"] = Tracer("bench-tail")
            self.poppy_tracer.anchor()
            set_process_tracer(self.poppy_tracer)

        def stop(self):
            self.poppy_off_t = self.poppy_tracer.now()
            set_process_tracer(None)
            super().stop()
            self.poppy_tracer.resolve()
    torch.profiler.profile = Profile

    class Timeline(PhaseTimeline):
        @classmethod
        def from_profile(cls, prof, window_s):
            seen["timeline"] = super().from_profile(prof, window_s)
            return seen["timeline"]
    profile_mod.Timeline = Timeline

    load_cell = harness.load_cell

    def load(name):
        spec = load_cell(name)
        have = {m["name"] for m in spec["per_layer"]}
        spec["per_layer"] += [m for m in METRICS if m["name"] not in have]
        return spec
    harness.load_cell = load
    return seen


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    import torch

    from bench import harness, profile
    if not torch.cuda.is_available():
        print("bench: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    install(harness, profile, torch)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda",
                           t_process=T_PROCESS)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
