"""The readers of the engine's own tracing (``bench/phases.py`` and its
four metrics): their arithmetic on a synthetic run, and their silence
where the program has no such spans or counters."""

import pytest

from bench import phases
from bench.harness import Obs, reader
from bench.profile import Timeline
from bench.tests.test_bench_metrics import RUN, synthetic
from repro_torch.obs import Tracer

NAMES = [m["name"] for m in phases.METRICS]


def spans(trz, listing):
    """Record ``(name, t0, t1, parent index, attrs)`` spans on ``trz``'s
    clock; → the spans."""
    out = []
    for name, t0, t1, parent, attrs in listing:
        sp = trz.begin(name, parent=out[parent] if parent is not None
                       else None, **attrs)
        sp.t0, sp.t1 = t0, t1
        out.append(sp)
    return out


def timeline():
    """Device operations in [0, 10] with idle gaps [1, 2] (mid 1.5),
    [3, 5] (mid 4), [6, 6.5] (mid 6.25) and [7, 9] (mid 8); the program's
    spans on a tracer clock 100 s ahead of the profiler's."""
    ops = [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("k", 5.0, 6.0),
           ("k", 6.5, 7.0), ("k", 9.0, 10.0)]
    tl = phases.PhaseTimeline(ops, {"bench.prefill_chunk": [(0.5, 4.5)]},
                              {}, window_s=10.0)
    trz = Tracer()
    trz.anchors = [99.0, 100.0]
    spans(trz, [
        ("prefill.chunk", 100.5, 104.5, None, {"device_ms": 30.0}),
        ("prefill.forward", 101.0, 104.0, 0, {}),
        ("decode.step", 105.5, 109.5, None, {}),
        ("decode.replay", 105.5, 106.0, 2, {}),
        ("decode.sync", 107.5, 108.5, 2, {}),
        ("prefill.chunk", 111.0, 112.0, None, {"device_ms": 10.0}),
        ("decode.step", 160.0, 161.0, None, {}),  # after the switch-off
    ])
    # the anchor ranges start at -1 and 0.5 on the profiler's clock (the
    # second 0.5 s after its reading): shift -100
    tl.attach(trz, [-1.0, 0.5], off_t=150.0)
    return tl


def test_spans_on_the_profiler_clock():
    tl = timeline()
    assert [(n, a, b) for n, a, b, _ in tl.program][:2] == [
        ("prefill.chunk", 0.5, 4.5), ("prefill.forward", 1.0, 4.0)]
    assert len(tl.program) == 6            # the late step left out
    assert tl.idle_in(("prefill.chunk",)) == pytest.approx(1.0 + 2.0)
    assert tl.idle_in(("prefill.forward",)) == pytest.approx(3.0)
    # in a step, outside its replay [5.5, 6] and sync [7.5, 8.5]: the gap
    # at mid 6.25 only (the one at 8 lies in the sync)
    assert tl.idle_in(("decode.step",), outside=(
        "decode.replay", "decode.sync")) == pytest.approx(0.5)
    # the breakdown's own bucket, by the bench's host range, agrees
    assert dict(tl.idle_gaps(top=None))["prefill_chunk"] \
        == pytest.approx(tl.idle_in(("prefill.chunk",)))


def test_no_anchor_range_maps_nothing():
    tl = phases.PhaseTimeline([], {}, {}, window_s=4.0)
    trz = Tracer()
    trz.anchors = [1.0]
    spans(trz, [("prefill.chunk", 1.5, 2.0, None, {})])
    tl.attach(trz, [], off_t=9.0)
    assert tl.program == () and tl.idle_in(("prefill.chunk",)) == 0.0


def test_readers_arithmetic():
    ob = synthetic()
    ob.engine.update(queue_wait_s=1.0, prefill_wait_s=3.0, prefill_s=2.0,
                     decode_s=4.0)
    ob.timeline = timeline()
    assert reader("call_prefill_wait_share")(ob) == pytest.approx(0.3)
    assert reader("prefill_chunk_device_ms")(ob) == pytest.approx(20.0)
    assert reader("prefill_forward_idle_share")(ob) == pytest.approx(0.3)
    assert reader("decode_host_idle_share")(ob) == pytest.approx(0.05)


@pytest.mark.parametrize("name", NAMES)
def test_readers_are_silent_without_the_programs_tracing(name):
    """A run of a program without the lifecycle counters, the spans or
    the anchor (a plain ``Timeline``), and a run with nothing in it."""
    old = synthetic()
    assert isinstance(old.timeline, Timeline)
    assert reader(name)(old) is None
    empty = Obs(run=RUN, window=(0.0, 10.0), host_window=(0.0, 6.0),
                setup_s=1.0, programs=[])
    assert reader(name)(empty) is None
    empty.engine = dict.fromkeys(
        ("queue_wait_s", "prefill_wait_s", "prefill_s", "decode_s"), 0.0)
    empty.timeline = phases.PhaseTimeline([], {}, {}, window_s=4.0)
    assert reader(name)(empty) is None
