"""The port engine's own tracing beyond the reference's: the phases of
each prefill chunk and decode step (``PORT_SPANS``), the process-wide
tracer that reaches a running engine loop, the call-lifecycle counters,
the untraced path's zero span allocations, and the anchor that maps
spans onto ``torch.profiler``'s clock."""

import asyncio
import contextlib
import time

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: one intra-op thread, so parallel test workers do not
# compete with idle-spinning thread pools
torch.set_num_threads(1)

from helpers_torch import PREFIX, build_pair  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import spans  # noqa: E402
from repro_torch.serving.engine import PORT_SPANS, ServingEngine  # noqa: E402

CHUNK = ("prefill.prep", "prefill.forward", "prefill.post")
STEP = ("decode.upload", "decode.replay", "decode.sync", "decode.tokens")


@pytest.fixture(scope="module")
def dense():
    return build_pair("stablelm-3b")


def _engine(dense, **kw):
    _, _, _, mt, params_t = dense
    kw = {"max_slots": 4, "max_len": 64, "page_size": 16,
          "prefill_chunk": 8, **kw}
    return ServingEngine(mt, params_t, device="cpu", **kw)


def _burst(engine):
    """A warmed shared prefix, then a fan-out of chunked prompts."""
    async def go():
        await engine.warm_prefix(PREFIX)
        outs = await asyncio.gather(*[
            engine.generate(PREFIX + list(range(100 + i, 120 + i)),
                            max_new_tokens=6) for i in range(3)])
        await engine.stop()
        return outs
    return asyncio.run(go())


def _children(trz):
    kids = {}
    for s in trz.spans:
        kids.setdefault(s.parent_id, []).append(s)
    return kids


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_every_chunk_and_step_has_its_phases(dense):
    engine = _engine(dense)
    with obs.tracing() as trz:
        _burst(engine)
    kids = _children(trz)
    chunks = [s for s in trz.spans if s.name == "prefill.chunk"]
    steps = [s for s in trz.spans if s.name == "decode.step"]
    assert len(chunks) == engine.prefill_chunks > 3
    assert len(steps) == engine.steps > 0
    for c in chunks:
        mine = kids[c.span_id]
        assert tuple(s.name for s in mine) == CHUNK
        assert all(_inside(s, c) and s.track == c.track for s in mine)
    for st in steps:
        mine = kids[st.span_id]
        assert tuple(s.name for s in mine) == STEP
        assert all(_inside(s, st) and s.track == st.track for s in mine)
        # consecutive: each phase starts where the one before it ended
        assert all(a.t1 == b.t0 for a, b in zip(mine, mine[1:]))
    # a chunk that continues a task (KV already covered) is followed, in
    # record order after its own phases, by one concat beside it
    order = trz.spans
    for c in chunks:
        after = order[order.index(c) + 1 + len(CHUNK):]
        follows = after[0] if after else None
        concat = follows is not None and follows.name == "prefill.concat"
        assert concat == (c.attrs["covered"] > 0), c.attrs
        if concat:
            assert (follows.parent_id, follows.track) \
                == (c.parent_id, c.track) and follows.t0 >= c.t1
    concats = [s for s in order if s.name == "prefill.concat"]
    assert len(concats) == sum(c.attrs["covered"] > 0 for c in chunks)
    # one finalize per task prefilled: the warm task and each request
    by_id = {s.span_id: s for s in order}
    fin = [s for s in order if s.name == "prefill.finalize"]
    assert sorted(by_id[s.parent_id].name for s in fin) \
        == ["request"] * 3 + ["warm_prefix"]
    assert {s.name for s in order} >= set(PORT_SPANS)
    assert not any(s.open for s in order)


def test_process_tracer_records_requests_submitted_before_it(dense):
    """Switched on mid-run, the process-wide tracer records the chunks and
    steps of requests already in the engine, detached (no request span of
    theirs exists); off again, nothing is recorded."""
    engine = _engine(dense, max_slots=2)
    trz = obs.Tracer()

    async def go():
        tasks = [asyncio.ensure_future(engine.generate(
            list(range(1 + i, 41 + i)), max_new_tokens=8)) for i in range(3)]
        while engine.prefill_chunks < 2:
            await asyncio.sleep(0)
        assert obs.current_tracer() is None
        assert obs.set_process_tracer(trz) is None
        try:
            at = engine.prefill_chunks, engine.steps
            assert obs.current_tracer() is trz
            with obs.tracing() as mine:          # a context's own wins
                assert obs.current_tracer() is mine
            await asyncio.gather(*tasks)
            done = engine.prefill_chunks - at[0], engine.steps - at[1]
        finally:
            assert obs.set_process_tracer(None) is trz
        await engine.stop()
        return done

    chunks, steps = asyncio.run(go())
    assert obs.current_tracer() is None
    names = [s.name for s in trz.spans]
    assert "request" not in names
    assert names.count("prefill.chunk") == chunks > 0
    assert names.count("decode.step") == steps > 0
    kids = _children(trz)
    for s in trz.spans:
        if s.name == "prefill.chunk":
            assert s.parent_id == 0
            assert tuple(k.name for k in kids[s.span_id]) == CHUNK
        elif s.name == "decode.step":
            assert tuple(k.name for k in kids[s.span_id]) == STEP
    n = len(trz.spans)
    _burst(engine)
    assert len(trz.spans) == n


def test_loop_started_under_one_tracer_records_each_request_on_its_own(dense):
    """The engine loop copies the context of the request that started it.
    Started under tracer A, it records a later request traced under B on
    B (its chunks under B's request span, the decode steps while it
    decodes) and an untraced request on none: A gets nothing once its
    ``tracing()`` has exited."""
    engine = _engine(dense, max_slots=2)
    a, b = obs.Tracer(), obs.Tracer()

    async def traced(prompt):
        with obs.tracing(b):
            return await engine.generate(prompt, max_new_tokens=6)

    async def go():
        with obs.tracing(a):
            await engine.generate(list(range(1, 21)), max_new_tokens=4)
        loop, n = engine._task, len(a.spans)
        at = engine.prefill_chunks, engine.steps
        outs = await asyncio.gather(
            traced(list(range(30, 55))),
            engine.generate(list(range(60, 93)), max_new_tokens=12))
        assert engine._task is loop            # one loop served all three
        done = engine.prefill_chunks - at[0], engine.steps - at[1]
        await engine.stop()
        return n, outs, done

    n, outs, (chunks, steps) = asyncio.run(go())
    assert [len(o) for o in outs] == [6, 12]
    assert n > 0 and len(a.spans) == n
    assert not engine._decode_tracers
    by_id = {s.span_id: s for s in b.spans}
    (req,) = [s for s in b.spans if s.name == "request"]
    mine = [s for s in b.spans if s.name == "prefill.chunk"]
    # 25 prompt tokens in chunks of 8: four chunks, all under the request
    assert len(mine) == 4 < chunks
    assert all(by_id[s.parent_id] is req for s in mine)
    # its admission's paging too, on B and nowhere else
    assert [s.name for s in b.spans if s.cat == "serving.paging"] \
        == ["page.alloc", "page.fill"]
    # the steps while B's request decodes (five: its first token comes
    # from the prefill), none of the untraced request's last six
    n_steps = sum(s.name == "decode.step" for s in b.spans)
    assert 5 <= n_steps <= steps - 6


@pytest.mark.parametrize("package", ["repro_torch", "repro"])
def test_chunk_device_time_where_the_tracer_keeps_it(dense, monkeypatch,
                                                     package):
    """An engine on a CUDA device (here its event pairs faked) keeps a
    chunk's event pair on a tracer of the port's, which ``resolve`` turns
    into the span's ``device_ms``; a ``repro.obs.Tracer`` has no
    ``time_device``, so no pair is made and the engine serves as well."""
    class Event:
        made, clock = 0, 0.0

        def __init__(self, enable_timing=False):
            Event.made += 1
            self.t = None

        def record(self, stream=None):
            self.t, Event.clock = Event.clock, Event.clock + 1.0

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: None)
    engine = _engine(dense)
    engine._chunk_events = True
    with contextlib.ExitStack() as stack:
        if package == "repro":
            from repro import obs as obs_ref
            trz = obs_ref.Tracer()
            stack.enter_context(obs_ref.tracing(trz))
        else:
            trz = obs.Tracer()
        stack.enter_context(obs.tracing(trz))
        outs = _burst(engine)
    assert all(len(o) == 6 for o in outs)
    chunks = [s for s in trz.spans if s.name == "prefill.chunk"]
    assert len(chunks) == engine.prefill_chunks > 3
    if package == "repro":
        assert Event.made == 0 and not hasattr(trz, "time_device")
    else:
        assert Event.made == 2 * len(chunks)
        trz.resolve()
        assert all(c.attrs["device_ms"] == 1.0 for c in chunks)


def test_untraced_run_allocates_no_spans(dense):
    assert obs.current_tracer() is None
    engine = _engine(dense)
    before = spans.SPAN_ALLOCS
    outs = _burst(engine)
    assert all(len(o) == 6 for o in outs) and engine.prefill_chunks > 3
    assert spans.SPAN_ALLOCS == before, \
        "untraced engine run allocated spans — the disabled path regressed"


@pytest.mark.parametrize("kv_layout", ["paged", "contiguous"])
def test_lifecycle_counters_sum_to_request_time(dense, kv_layout):
    """Each finished request's four phases (queued, waiting behind other
    tasks' chunks, prefilling, decoding) sum to finish - submit, and the
    engine's counters are those phases summed; an abandoned request adds
    nothing."""
    engine = _engine(dense, max_slots=2, kv_layout=kv_layout)
    finished = []
    finish = engine._finish

    def _finish(slot):
        req = engine.active[slot]
        finished.append((req, req.abandoned))
        finish(slot)
    engine._finish = _finish

    async def go():
        tasks = [asyncio.ensure_future(engine.generate(
            list(range(1 + i, 25 + i)), max_new_tokens=6)) for i in range(3)]
        victim = asyncio.ensure_future(engine.generate(
            list(range(50, 60)), max_new_tokens=40))
        await asyncio.gather(*tasks)
        while not any(r.slot >= 0 and r.first_token_at
                      for r in engine.active.values()
                      if r.max_new_tokens == 40):
            await asyncio.sleep(0)
        victim.cancel()
        with pytest.raises(asyncio.CancelledError):
            await victim
        await engine.stop()

    asyncio.run(go())
    done = [r for r, abandoned in finished if not abandoned]
    assert len(done) == 3 and len(finished) == 4
    st = engine.stats()
    assert st["requests_finished"] == engine.requests_finished == 3
    phases = {"queue_wait_s": lambda r: r.started_at - r.submitted_at,
              "prefill_wait_s": lambda r: r.prefill_at - r.started_at,
              "prefill_s": lambda r: r.first_token_at - r.prefill_at,
              "decode_s": lambda r: r.finished_at - r.first_token_at}
    for r in done:
        assert all(f(r) >= 0 for f in phases.values())
        assert sum(f(r) for f in phases.values()) \
            == pytest.approx(r.finished_at - r.submitted_at, abs=1e-9)
    for key, f in phases.items():
        assert st[key] == pytest.approx(sum(map(f, done)), abs=1e-9), key
    assert sum(st[k] for k in phases) == pytest.approx(
        sum(r.finished_at - r.submitted_at for r in done), abs=1e-9)
    # two slots, three requests: one queued; two admitted together, one
    # of whose first chunks waited behind the other's
    assert st["queue_wait_s"] > 0 and st["prefill_wait_s"] > 0


def test_anchor_maps_spans_onto_profiler_clock():
    """An anchored tracer's spans, put on the profiler's clock, land
    within 0.5 ms of ``record_function`` ranges opened back to back with
    them (the median of nine: a probe whose process lost the CPU between
    its two clock reads stands apart)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile, record_function

    trz = obs.Tracer()
    assert trz.anchors == [] and trz.profiler_offset([]) is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert len(trz.anchor()) == spans.ANCHOR_RANGES
        probes = []
        for i in range(9):
            time.sleep(0.002)
            sp = trz.begin("probe")
            with record_function(f"probe{i}"):
                time.sleep(0.001)
            probes.append(trz.end(sp))
    events = list(prof.profiler.kineto_results.events())
    starts = [e.start_ns() * 1e-9 for e in events
              if e.name() == spans.ANCHOR]
    offset = trz.profiler_offset(starts)
    by = {e.name(): e for e in events}
    errs = []
    for i, sp in enumerate(probes):
        e = by[f"probe{i}"]
        a = e.start_ns() * 1e-9
        b = a + e.duration_ns() * 1e-9
        errs += [abs(sp.t0 + offset - a), abs(sp.t1 + offset - b)]
    assert statistics.median(errs) < 0.5e-3, errs


def test_profiler_offset_takes_the_least_delayed_range():
    """A range that starts late after its reading raises its start minus
    the reading; the offset is the least, and needs every range."""
    trz = obs.Tracer()
    trz.anchors = [10.0, 10.2, 10.3]
    # true offset 90: the second range started 5 ms after its reading
    assert trz.profiler_offset([100.3, 100.0, 100.205]) \
        == pytest.approx(90.0)
    assert trz.profiler_offset([100.0, 100.2]) is None


def test_resolve_writes_device_ms_once():
    """``time_device`` keeps an event pair without waiting; ``resolve``
    waits for each pair's end and writes its span's ``device_ms``."""
    class Event:
        def __init__(self, t):
            self.t, self.waited = t, 0

        def synchronize(self):
            self.waited += 1

        def elapsed_time(self, end):
            return end.t - self.t

    trz = obs.Tracer()
    sp = trz.end(trz.begin("prefill.chunk"))
    a, b = Event(1.0), Event(4.5)
    trz.time_device(sp, a, b)
    assert "device_ms" not in sp.attrs and b.waited == 0
    trz.resolve()
    trz.resolve()
    assert sp.attrs["device_ms"] == 3.5 and b.waited == 1
