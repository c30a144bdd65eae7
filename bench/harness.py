"""One run of one cell: set-up, the measured window, the checks.

The window drives the port's main path: the mix's ``@poppy`` programs
run through ``PoppyFn.async_call``, many at once on one asyncio loop;
their ``llm`` calls go to one ``repro_torch.dispatch.Dispatcher``
(admission at the engine's slots), a ``LocalEngineBackend`` and one
``ServingEngine`` (paged KV, prefix cache, CUDA-graph decode step, flash
and paged-attention kernels).  Warm-up runs on the same loop.

Clients form a closed loop: each of the mix's ``clients`` starts its next
program when its last one returns.  The window opens once every client's
program is past its first call; it closes ``seconds`` later, no client
starts another program, and every program in flight runs to its end.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import time

import torch

from . import check, traffic

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# the traced run profiles the last PROFILE_S seconds of the window (at
# most half of it); the host-clock and counter metrics of the traced run
# read the part before it
PROFILE_S = 4.0
# an in-flight program must end this long after the window closes
DRAIN_S = 90.0


# -- the cell's files ---------------------------------------------------------


def _json(path):
    return json.loads(pathlib.Path(path).read_text())


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and metrics."""
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(m):
        return name in m.get("workloads", [name])
    return {
        "cell": cell,
        "config": _json(ROOT / config["file"]),
        "mix": _json(BENCH / "mixes" / f"{cell['traffic']}.json"),
        "limits": _json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
        "per_layer": [m for m in spec["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """The ``read(obs)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def port_config(run: dict):
    """The port's ``ModelConfig`` as the configuration file's ``run`` block
    states it; raises where the port's config differs."""
    from repro_torch.configs import get_config
    cfg = get_config(run["arch"])
    fields = {f.name for f in dataclasses.fields(cfg)}
    cfg = cfg.replace(**{k: v for k, v in run.items()
                         if k in fields and k != "name"})
    for k, v in run.items():
        have = getattr(cfg, k, None)
        if k in ("arch", "serve_dtype") or have == v:
            continue
        raise ValueError(f"{run['arch']}: the port's {k} is {have!r}, the "
                         f"configuration file states {v!r}")
    return cfg


def check_tree(model, tree):
    """The weights' layout is the port's schema, leaf for leaf."""
    want = model.abstract_params()

    def walk(a, b, path):
        if set(a) != set(b):
            raise ValueError(f"weights {path}: keys {sorted(b)} against "
                             f"the port's {sorted(a)}")
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + "/" + k)
            elif tuple(a[k].shape) != tuple(b[k].shape):
                raise ValueError(f"weights {path}/{k}: {tuple(b[k].shape)}"
                                 f" against the port's {tuple(a[k].shape)}")
    walk(want, tree, "")


# -- what a run records -------------------------------------------------------


@dataclasses.dataclass
class Program:
    pid: int
    kind: str
    args: tuple
    t_start: float
    t_end: float = math.nan
    ok: bool = False
    result: object = None
    lines: list = dataclasses.field(default_factory=list)
    llm: list = dataclasses.field(default_factory=list)      # (t0, t1)
    externals: list = dataclasses.field(default_factory=list)
    trace: object = None                # the core Trace while it runs

    def past_first_call(self) -> bool:
        return self.trace is not None and any(
            ev.name == "llm" and ev.t_resolve > 0 for ev in self.trace.events)


@dataclasses.dataclass
class Obs:
    """What the metric readers read.  Times are ``time.monotonic()``
    seconds; ``host_window`` is the part of the window that the host-clock
    and counter metrics read (the whole window, or in the traced run the
    part before the profiled tail)."""
    run: dict
    window: tuple
    host_window: tuple
    setup_s: float
    programs: list
    engine: dict = dataclasses.field(default_factory=dict)
    chunks: list = dataclasses.field(default_factory=list)  # t, n, prefix, s
    steps: list = dataclasses.field(default_factory=list)   # t, contexts
    timeline: object = None

    def calls_in(self, a, b):
        """(t0, t1) of every ``llm`` call dispatched in [a, b]."""
        return [c for p in self.programs for c in p.llm if a <= c[0] <= b]

    def programs_done_in(self, a, b):
        return [p for p in self.programs if p.ok and a <= p.t_end <= b]


class Recorder:
    """Wraps the engine's ``generate`` (prompt tokens → served tokens) and
    the backend's (prompt text → output text) to record every call."""

    def __init__(self, engine, backend):
        self.requests, self.outputs = [], []
        gen, bgen = engine.generate, backend.generate

        async def generate(prompt_tokens, **kw):
            t = time.monotonic()
            out = await gen(prompt_tokens, **kw)
            self.requests.append((t, tuple(prompt_tokens), tuple(out)))
            return out

        async def backend_generate(prompt, *, max_tokens, **kw):
            out = await bgen(prompt, max_tokens=max_tokens, **kw)
            self.outputs.append(((prompt, max_tokens), out))
            return out
        engine.generate = generate
        backend.generate = backend_generate


class Tracer:
    """The traced run's instruments: ``bench.*`` ranges around the
    engine's prefill chunks and decode steps (and the MoE layer), a CUDA
    event pair around each prefill chunk, each decode step's attended
    context lengths."""

    def __init__(self, engine, device):
        from torch.profiler import record_function

        from repro_torch.models import moe
        self.chunks, self.steps, self._events = [], [], []
        timed = device.type == "cuda"
        run_prefill, decode_once = engine._run_prefill, engine._decode_once
        apply_moe = moe.apply_moe

        def _run_prefill(seg, prefix_kv, prefix_len, prefix_key=()):
            t = time.monotonic()
            with record_function("bench.prefill_chunk"):
                if timed:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                out = run_prefill(seg, prefix_kv, prefix_len, prefix_key)
                if timed:
                    b.record()
                    self._events.append((len(self.chunks), a, b))
            self.chunks.append([t, len(seg), int(prefix_len), None])
            return out

        def _decode_once():
            t = time.monotonic()
            ctx = [int(engine._positions[s]) + 1 for s in engine.active]
            with record_function("bench.decode_step"):
                decode_once()
            self.steps.append((t, ctx))

        def _apply_moe(cfg, p, x):
            with record_function("bench.moe"):
                return apply_moe(cfg, p, x)
        engine._run_prefill = _run_prefill
        engine._decode_once = _decode_once
        moe.apply_moe = _apply_moe
        self._restore = lambda: setattr(moe, "apply_moe", apply_moe)

    def close(self):
        self._restore()
        if self._events:
            torch.cuda.synchronize()
        for i, a, b in self._events:
            self.chunks[i][3] = a.elapsed_time(b) / 1e3


# -- the run ---------------------------------------------------------------------


def engine_counters(engine) -> dict:
    return {"steps": engine.steps, "decode_tokens": engine.decode_tokens,
            "prefill_chunks": engine.prefill_chunks,
            "prefill_tokens_computed": engine.prefill_tokens_computed,
            "prefill_tokens_reused": engine.prefill_tokens_reused,
            "occupancy": len(engine.batch_occupancy)}


def build(spec, seed, device, shrink=None):
    """(run block, port config, model, weights, engine)."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    from . import weights
    run, mix = dict(spec["config"]["run"]), spec["mix"]
    if shrink is not None:
        run, mix = shrink(run, mix)
        spec["mix"] = mix
    cfg = port_config(run)
    model = build_model(cfg)
    tree = weights.make_weights(run, seed, device, cfg.activation_dtype)
    check_tree(model, tree)
    e = mix["engine"]
    ps = e["page_size"]
    num_pages = e["max_slots"] * (e["max_len"] // ps) \
        + e["prefix_cache_tokens"] // ps
    page_bytes = 2 * cfg.num_layers * ps * cfg.num_kv_heads * cfg.head_dim \
        * torch.tensor([], dtype=cfg.activation_dtype).element_size()
    engine = ServingEngine(
        model, tree, max_slots=e["max_slots"], max_len=e["max_len"],
        page_size=ps, num_pages=num_pages, prefill_chunk=e["prefill_chunk"],
        prefix_cache_budget=(e["prefix_cache_tokens"] // ps) * page_bytes,
        kv_layout="paged", device=device, seed=0)
    return run, cfg, model, tree, engine


async def drive(engine, mix, programs, effects, stream, warm, seconds, *,
                t_process, trace, device):
    """Warm-up, ramp, window, drain → (Obs fields, Recorder, Tracer)."""
    from repro_torch.core import recording
    from repro_torch.core.ai import use_dispatcher
    from repro_torch.dispatch import AdmissionPolicy, Dispatcher
    from repro_torch.serving.backend import LocalEngineBackend

    from .tokenizer import IdTokenizer
    backend = LocalEngineBackend(
        engine, tokenizer=IdTokenizer(engine.cfg.vocab_size))
    rec = Recorder(engine, backend)
    dispatcher = Dispatcher([backend], admission=AdmissionPolicy(
        max_concurrency=engine.max_slots))
    records, current = [], {}
    state = {"next": 0, "open": True}

    async def one(pid, kind, args):
        p = Program(pid, kind, args, time.monotonic())
        records.append(p)
        with recording() as tr:
            p.trace = tr
            try:
                p.result = await programs[kind].async_call(pid, *args)
                p.ok = True
            finally:
                p.t_end = time.monotonic()
                p.lines = list(effects.get(pid, []))
                for ev in tr.events:
                    if ev.seq_no < 0 or ev.t_resolve < ev.t_dispatch:
                        continue
                    span = (tr.t0 + ev.t_dispatch, tr.t0 + ev.t_resolve)
                    p.externals.append(span)
                    if ev.name == "llm":
                        p.llm.append(span)
                p.trace = None
        return p

    async def client(c):
        while state["open"]:
            i = state["next"]
            state["next"] += 1
            current[c] = i
            kind, args = stream(i)
            await one(i, kind, args)

    with use_dispatcher(dispatcher):
        t_warm = time.monotonic()
        for j, (kind, args) in enumerate(warm):
            await one(-1 - j, kind, args)
        t_ramp = time.monotonic()
        del records[:]
        tasks = [asyncio.get_running_loop().create_task(client(c))
                 for c in range(mix["clients"])]

        def steady():
            started = {p.pid: p for p in records}
            return len(current) == mix["clients"] and all(
                i in started and (started[i].past_first_call()
                                  or started[i].ok)
                for i in current.values())
        while not steady():
            await asyncio.sleep(0.005)
        t0 = time.monotonic()
        setup_s = t0 - t_process
        phases = {"before_warm_up_s": t_warm - t_process,
                  "warm_up_s": t_ramp - t_warm, "ramp_s": t0 - t_ramp}
        c0 = engine_counters(engine)
        tracer = Tracer(engine, device) if trace else None
        t1 = t0 + seconds
        prof, t_prof = None, t1
        if trace:
            t_prof = t1 - min(PROFILE_S, seconds / 2)
            await asyncio.sleep(max(0.0, t_prof - time.monotonic()))
            c1 = engine_counters(engine)
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            t_prof = time.monotonic()
        await asyncio.sleep(max(0.0, t1 - time.monotonic()))
        t1 = time.monotonic()
        state["open"] = False
        if prof is None:
            c1 = engine_counters(engine)
        else:
            prof.stop()
        done, pending = await asyncio.wait(tasks, timeout=DRAIN_S)
        for t in pending:
            t.cancel()
        await engine.stop()
    if tracer is not None:
        tracer.close()
    for t in done:
        if t.exception() is not None:
            print(f"client failed: {t.exception()!r}", flush=True)
    return {"window": (t0, t1), "t_prof": t_prof, "setup_s": setup_s,
            "phases": phases,
            "c0": c0, "c1": c1, "prof": prof}, records, rec, tracer


def run_cell(name, seed, seconds, trace, *, device, t_process, shrink=None,
             control=False):
    """One run of cell ``name`` → the result dict (the contract's last
    line), its check lines last.  ``control`` also reads the fp8
    control's gap on the same requests (``control.py``; the benchmark's
    own runs do not)."""
    from .programs import make_programs

    spec = load_cell(name)
    device = torch.device(device)
    t_build = time.monotonic()
    run, cfg, model, tree, engine = build(spec, seed, device, shrink)
    built = {"imports_s": t_build - t_process,
             "weights_engine_s": time.monotonic() - t_build}
    mix = spec["mix"]
    tr = traffic.Traffic(mix, seed)
    effects = {}
    programs = make_programs(effects)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w, records, rec, tracer = asyncio.run(drive(
        engine, mix, programs, effects, tr.instance, tr.warm(), seconds,
        t_process=t_process, trace=trace, device=device))
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    t0, t1 = w["window"]
    host_window = (t0, w["t_prof"])
    ob = Obs(run=run, window=(t0, t1),
             host_window=host_window, setup_s=w["setup_s"],
             programs=records)
    ob.engine = {k: w["c1"][k] - w["c0"][k] for k in w["c0"]
                 if k != "occupancy"}
    occ0, occ1 = w["c0"]["occupancy"], w["c1"]["occupancy"]
    ob.engine["occupancy"] = engine.batch_occupancy[occ0:occ1]
    ob.engine["decode_step_s"] = engine.decode_step_s[occ0:occ1]
    devinfo = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": torch.cuda.get_device_name(device)
               if device.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        from .profile import Timeline
        ob.chunks, ob.steps = tracer.chunks, tracer.steps
        tl = Timeline.from_profile(w["prof"], t1 - w["t_prof"])
        ob.timeline = tl
        devinfo["busy_s"] = tl.busy_s
        devinfo["window_s"] = tl.window_s
        breakdown = {"device_ops": [[n, s] for n, s in tl.device_ops()],
                     "idle_gaps": [[n, s] for n, s in tl.idle_gaps()]}
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = reader(m["name"])(ob)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the checks, once the window's state is freed
    attempted = len(records)
    failed = sum(not p.ok for p in records)
    setup_phases = {**built, **w["phases"]}
    del engine, tracer, w
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    from . import replay
    in_window = [(p, o) for t, p, o in rec.requests if t0 <= t <= t1]
    sample = check.sample_requests(in_window, seed,
                                   count=mix["check"]["requests"],
                                   served=mix["check"]["served_tokens"])
    from . import weights
    del tree
    tree = weights.make_weights(run, seed, device, cfg.activation_dtype)
    model_r = check.model_readings(run, tree, sample, control=control)
    del tree
    readings = {
        "served_token_logit_gap": model_r["gap"],
        "served_token_mean_gap": model_r["mean_gap"],
        "runtime_mismatches": replay.mismatches(
            [p for p in records if p.ok], rec.outputs,
            [(p, o) for _, p, o in rec.requests]),
        "failed_programs": failed,
    }
    correct, lines = check.verdict(
        {k: v for k, v in readings.items() if k in spec["limits"]},
        spec["limits"])
    lines["checked_tokens"] = {"value": model_r["tokens"],
                               "limit": mix["check"]["served_tokens"]}
    correct = correct and model_r["tokens"] >= mix["check"]["served_tokens"]
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": devinfo}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["control"] = model_r
    # where set-up went, and the engine's counters over the host window
    # and how many calls' outputs differ: the replay sees a call handed
    # another's output only where the two differ
    texts = [text for _, text in rec.outputs]
    out["diag"] = {**setup_phases, **{k: v for k, v in ob.engine.items()
                                      if not isinstance(v, list)},
                   "outputs": len(texts), "outputs_distinct": len(set(texts))}
    out["checks"] = lines
    return out
