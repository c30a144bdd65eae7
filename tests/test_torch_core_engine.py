"""The port's PopPy core driving the port's paged engine, against the
reference's core driving the JAX engine, on the CPU.

Both engines serve reduced stablelm-3b in float32 on the same parameters
(the JAX init, converted with ``convert.from_jax``), each behind its own
package's ``Dispatcher`` and ``LocalEngineBackend``; the program
(``tests/torch_core_programs.py::summarize``, a fan-out and its combine) is
loaded under each package.  Results, ordered output and every call's greedy
tokens must be equal, under standard Python and under PopPy, and PopPy's
calls must share decode steps.  Then the port alone, in a child process
that refuses to import ``repro`` or ``jax``: the same program on a
``SimulatedBackend`` and on a tiny CPU engine.
"""

import contextlib
import importlib
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from helpers_torch import CORPUS, core_of, load_under  # noqa: E402
from repro.configs import get_config as get_config_jax  # noqa: E402
from repro.models import build_model as build_jax  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENGINE = dict(max_slots=4, max_len=256, prefix_cache_budget=0)


@pytest.fixture(scope="module")
def served():
    cfg_j = get_config_jax("stablelm-3b").reduced()
    mj = build_jax(cfg_j)
    params_j = mj.init(jax.random.PRNGKey(7))
    cfg = get_config("stablelm-3b").reduced()
    mt = build_model(cfg)
    params_t = from_jax(cfg, jax.tree.map(np.asarray, params_j),
                        device="cpu")
    return (mj, params_j), (mt, params_t)


def _drive(package, engine, tmp_path, *, sequential):
    """``summarize(4)`` under ``package``'s core, through its dispatcher
    and backend into ``engine``: → (result, output, sorted (prompt
    tokens, greedy tokens) of every call)."""
    core, ai, _ = core_of(package)
    dispatch = importlib.import_module(f"{package}.dispatch")
    backend = importlib.import_module(f"{package}.serving.backend")
    mod = load_under(package, CORPUS["core_programs"], tmp_path)
    calls = []
    real = engine.generate

    async def generate(prompt_tokens, **kw):
        out = await real(prompt_tokens, **kw)
        calls.append((tuple(prompt_tokens), tuple(int(t) for t in out)))
        return out
    engine.generate = generate
    d = dispatch.Dispatcher([backend.LocalEngineBackend(engine)],
                            admission=dispatch.AdmissionPolicy(
                                max_concurrency=engine.max_slots))
    mod.reset()
    with ai.use_dispatcher(d), (core.sequential_mode() if sequential
                                else contextlib.nullcontext()):
        result = mod.summarize(4)
    return result, list(mod.OUT), sorted(calls)


@pytest.mark.parametrize("mode", ["standard", "poppy"])
def test_port_core_and_engine_match_the_reference(served, mode, tmp_path):
    (mj, pj), (mt, pt) = served
    ej = JaxEngine(mj, pj, **ENGINE)
    et = ServingEngine(mt, pt, device="cpu", **ENGINE)
    sequential = mode == "standard"
    want = _drive("repro", ej, tmp_path, sequential=sequential)
    got = _drive("repro_torch", et, tmp_path, sequential=sequential)
    assert got == want
    assert len(got[2]) == 5 and all(len(t) in (8, 6) for _, t in got[2])
    if sequential:
        assert max(et.batch_occupancy) == 1
    else:
        assert max(et.batch_occupancy) >= 2, \
            "parallel PopPy calls did not share decode steps"


STANDALONE = '''
import importlib.abc
import sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("repro", "jax", "jaxlib"):
            raise ImportError(f"{name} refused: the port stands alone")
        return None


sys.meta_path.insert(0, Refuse())

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import poppy, sequential, sequential_mode  # noqa: E402
from repro_torch.core.ai import SimulatedBackend, llm, use_backend, \\
    use_dispatcher  # noqa: E402
from repro_torch.dispatch import AdmissionPolicy, Dispatcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.backend import LocalEngineBackend  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

torch.set_num_threads(1)
OUT = []


@sequential
def report(line):
    OUT.append(line)
    return None


@poppy
def summarize_documents(n_docs):
    summaries = tuple()
    for i in range(n_docs):
        s = llm(f"summarize document {i}", max_tokens=8)
        report(f"doc {i}: {s}")
        summaries += (s,)
    overall = llm(f"combine: {summaries}"[:64], max_tokens=6)
    report(f"combined: {overall}")
    return overall


def both_modes():
    OUT.clear()
    with sequential_mode():
        seq = summarize_documents(4)
    seq_out = list(OUT)
    OUT.clear()
    pop = summarize_documents(4)
    assert (seq, seq_out) == (pop, OUT), ((seq, seq_out), (pop, OUT))
    return pop


with use_backend(SimulatedBackend(base_s=0.002, per_token_s=0.0002)) as b:
    both_modes()
    assert b.max_in_flight == 4, b.max_in_flight

cfg = get_config("stablelm-3b").reduced()
model = build_model(cfg)
engine = ServingEngine(model, model.init(0, device="cpu"), max_slots=4,
                       max_len=256, prefix_cache_budget=0, device="cpu")
d = Dispatcher([LocalEngineBackend(engine)],
               admission=AdmissionPolicy(max_concurrency=4))
with use_dispatcher(d):
    both_modes()
assert max(engine.batch_occupancy) >= 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("repro", "jax", "jaxlib"))
assert not bad, bad
print("standalone ok", engine.steps)
'''


def test_port_runs_a_program_alone(tmp_path):
    """The port's core, dispatcher and engine with ``repro`` and ``jax``
    refused at import: a program on a ``SimulatedBackend``, then on a
    tiny CPU engine, equal under standard Python and PopPy."""
    script = tmp_path / "standalone.py"
    script.write_text(textwrap.dedent(STANDALONE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "standalone ok" in proc.stdout
