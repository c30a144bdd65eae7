"""The port's PopPy compiler and runtime (``repro_torch.core``) and journal
(``repro_torch.durability``) against the reference's, in one process.

Every program of the corpus (``benchmarks/apps``, ``examples/quickstart.py``,
``examples/multi_agent_debate.py`` and ``tests/torch_core_programs.py``) is
loaded once under each package (``helpers_torch.load_under``), so a program
runs on one package's symbols throughout.  Held: the Bezoar and λ^O texts of
every ``@poppy`` function are equal; with the deterministic
``SimulatedBackend`` each program gives the same result and ordered output
under both packages, its standard-Python and PopPy traces are ≡_A within
each package, and the two packages' standard-Python traces are equal event
for event on every field but the three times; a journal recorded under one
package resumes under the other with no backend call.
"""

import contextlib
import contextvars
import dataclasses
import importlib
import io
import json
import re
import warnings

import pytest

from helpers_torch import CORPUS, PACKAGES, core_of, load_under, \
    poppy_functions

TIMES = ("t_queue", "t_dispatch", "t_resolve")


def _texts(package, fn):
    """The Bezoar and λ^O texts of ``fn``, with the addresses of the
    constant functions they name and the package's name taken out."""
    bezoar = importlib.import_module(f"{package}.core.bezoar")
    lambda_o = importlib.import_module(f"{package}.core.lambda_o")
    return tuple(re.sub(r" at 0x[0-9a-f]+", "", t).replace("repro_torch",
                                                             "repro")
                 for t in (bezoar.format_func(fn.bezoar),
                           lambda_o.format_lfunc(fn.lfunc)))


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_compiled_texts_agree(name, tmp_path):
    mods = {p: load_under(p, CORPUS[name], tmp_path) for p in PACKAGES}
    fns = {p: poppy_functions(m) for p, m in mods.items()}
    assert fns["repro"] and fns["repro"].keys() == fns["repro_torch"].keys()
    for fname, fn in fns["repro"].items():
        port = fns["repro_torch"][fname]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            compiles = fn.compiles, port.compiles
        if compiles == (False, False):
            # outside the fragment in both: the same PoppyCompileError
            assert str(fn._compile_error) == str(port._compile_error)
            continue
        assert compiles == (True, True), fname
        assert _texts("repro", fn) == _texts("repro_torch", port), fname


# name -> (corpus module, run(mod) -> result, ordered output(mod))
def _out(mod):
    return list(mod.OUT)


APPS = {
    "tot": ("tot", lambda m: m.run(), _out),
    "sot": ("sot", lambda m: m.run(), _out),
    "dae": ("dae", lambda m: m.run(), _out),
    "bird": ("bird", lambda m: m.run(), _out),
    "traq": ("traq", lambda m: m.run(), _out),
    **{f"camel_{k}": ("camel", lambda m, k=k: m.run(k), _out)
       for k in ("C-1", "C-2", "C-3", "C-4", "C-5", "C-6", "C-13")},
    "quickstart_research": (
        "quickstart", lambda m: m.research("solar panels on every roof"),
        None),
    "quickstart_brief": (
        "quickstart", lambda m: m.brief(("reuters", "arxiv")), None),
    "debate": ("multi_agent_debate", lambda m: m.debate(m.QUESTION),
               lambda m: m.memory.snapshot()),
    **{f"runtime_{k}": ("core_programs", lambda m, k=k: m.RUNS[k](), _out)
       for k in ("summarize", "effects", "fan_out", "batched", "speculated",
                 "offloaded", "unpack", "failing", "fallback")},
}


def _run(package, mod, run, out, *, sequential):
    """One run of a corpus program under ``package``'s core with a fresh
    deterministic ``SimulatedBackend``: → (result, ordered output, trace,
    backend).  Programs that print are read from stdout."""
    core, ai, _ = core_of(package)
    getattr(mod, "reset", lambda: None)()
    if hasattr(mod, "memory"):
        mod.memory.clear()
    be = ai.SimulatedBackend(base_s=0.005, per_token_s=0.0005)
    printed = io.StringIO()
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(ai.use_backend(be))
        ctx.enter_context(contextlib.redirect_stdout(printed))
        trace = ctx.enter_context(core.recording())
        if sequential:
            ctx.enter_context(core.sequential_mode())
        result = run(mod)
    got = out(mod) if out is not None else printed.getvalue()
    return result, got, trace, be


def _fields(trace):
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k not in TIMES} for e in trace.events]


@pytest.mark.parametrize("app", sorted(APPS))
def test_programs_agree_across_packages(app, tmp_path):
    corpus, run, out = APPS[app]
    runs = {}
    for p in PACKAGES:
        core, _, _ = core_of(p)
        mod = load_under(p, CORPUS[corpus], tmp_path)
        seq = _run(p, mod, run, out, sequential=True)
        pop = _run(p, mod, run, out, sequential=False)
        assert seq[:2] == pop[:2], f"{p}: standard Python and PopPy differ"
        ok, why = core.equivalent(seq[2], pop[2])
        assert ok, f"{p}: {why}"
        runs[p] = (seq, pop)
    (ref_seq, ref_pop), (port_seq, port_pop) = runs["repro"], \
        runs["repro_torch"]
    assert port_pop[:2] == ref_pop[:2]
    assert _fields(port_seq[2]) == _fields(ref_seq[2])
    assert sorted(port_pop[3].calls) == sorted(ref_pop[3].calls)


@pytest.mark.parametrize("recorder,resumer", [("repro", "repro_torch"),
                                              ("repro_torch", "repro")])
def test_journal_resumes_across_packages(recorder, resumer, tmp_path):
    """A journal recorded under one package replays under the other: the
    resumed run makes no backend call, performs none of the recorded
    effects again (its ``emit`` lines are replayed, not printed) and gives
    the same result; with its torn last line, exactly one call runs
    again."""
    path = tmp_path / "run.journal"
    results = {}
    for package, mode in ((recorder, "record"), (resumer, "resume")):
        core, ai, durability = core_of(package)
        mod = load_under(package, CORPUS["sot"], tmp_path)
        be = ai.SimulatedBackend(base_s=0.002, per_token_s=0.0002)
        with ai.use_backend(be), durability.use_journal(path, mode=mode) \
                as j:
            results[mode] = (mod.run(), list(mod.OUT))
        results[mode + "_calls"] = len(be.calls)
        results[mode + "_stats"] = j.stats
    (result, out), (again, out_again) = results["record"], results["resume"]
    assert again == result and out and out_again == []
    assert results["record_calls"] > 0 and results["resume_calls"] == 0
    assert results["resume_stats"].replayed == \
        results["resume_stats"].loaded == results["record_calls"] + len(out)

    data = path.read_bytes()
    lines = data.splitlines(keepends=True)
    path.write_bytes(b"".join(lines[:-1]) + lines[-1][:len(lines[-1]) // 2])
    core, ai, durability = core_of(resumer)
    mod = load_under(resumer, CORPUS["sot"], tmp_path)
    be = ai.SimulatedBackend(base_s=0.002, per_token_s=0.0002)
    with ai.use_backend(be), durability.resume(path) as j:
        again = mod.run()
    assert again == result
    assert j.stats.torn == 1 and len(be.calls) + len(mod.OUT) == 1


def test_journal_keys_agree(tmp_path):
    """The journal's entries, recorded under each package, are the same
    lines but for the order concurrent calls resolved in."""
    lines = {}
    for p in PACKAGES:
        _, ai, durability = core_of(p)
        mod = load_under(p, CORPUS["bird"], tmp_path)
        path = tmp_path / f"{p}.journal"
        with ai.use_backend(ai.SimulatedBackend(base_s=0.001,
                                                per_token_s=0.0)), \
                durability.use_journal(path, fsync=False):
            mod.run()
        lines[p] = sorted((d["key"], d["n"], d["name"], d["value"])
                          for d in map(json.loads,
                                       path.read_text().splitlines()))
    assert lines["repro"] and lines["repro_torch"] == lines["repro"]


def test_port_has_no_simulated_fallback():
    """The reference falls back to a ``SimulatedBackend`` with nothing
    bound; the port raises, so a program never gets fake answers in place
    of the card's."""
    _, ref_ai, _ = core_of("repro")
    _, port_ai, _ = core_of("repro_torch")
    # the reference binds its fallback in the context: keep it in a copy
    fallback = contextvars.copy_context().run(ref_ai.get_backend)
    assert isinstance(fallback, ref_ai.SimulatedBackend)
    with pytest.raises(RuntimeError, match="no backend bound"):
        port_ai.get_backend()
    with port_ai.use_backend(port_ai.SimulatedBackend()) as b:
        assert port_ai.get_backend() is b


def test_first_success_agrees(tmp_path):
    """``first_success`` races two rollouts: the same winner under both
    packages, the loser cancelled and drained through the dispatcher."""
    got = {}
    for p in PACKAGES:
        _, ai, _ = core_of(p)
        dispatch = importlib.import_module(f"{p}.dispatch")
        mod = load_under(p, CORPUS["core_programs"], tmp_path)
        d = dispatch.Dispatcher()
        with ai.use_backend(ai.SimulatedBackend()), ai.use_dispatcher(d):
            got[p] = (mod.race("hello"), list(mod.OUT), d.stats.races,
                      d.stats.race_losers, d.stats.cancelled)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][2:] == (1, 1, 1)
