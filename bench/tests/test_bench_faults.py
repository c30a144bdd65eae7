"""A run driven past the look for a card, on the CPU at tiny widths: a
sound run comes out correct, and each fault the cells can have, planted
in the timed path, makes ``correct`` come out false.  Each is run at the
tiny vocabulary and at the cells' own (50304 ids), where nearly every
served id is no byte."""

import json
import pathlib
import time

import pytest

from bench.harness import load_cell, run_cell
from bench.tests.tiny import full_vocabulary, shrink

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = ["stablelm-3b.agent_loop", "stablelm-3b.mapreduce"]
SIZES = {"tiny_vocab": shrink, "full_vocab": full_vocabulary}


def run(cell, size):
    return run_cell(cell, 2**31 + 101, 4.0, False, device="cpu",
                    t_process=time.monotonic(), shrink=SIZES[size])


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, size):
    out = run(cell, size)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def token_altered(monkeypatch):
    """Each request's first token, as the engine produces it, is another
    one."""
    from repro_torch.serving.engine import ServingEngine
    real = ServingEngine._sample

    def sample(self, logits, req):
        tok = real(self, logits, req)
        return (tok + 97) % self.cfg.vocab_size
    monkeypatch.setattr(ServingEngine, "_sample", sample)


def answer_altered(monkeypatch):
    """The runtime hands each program a result that is not its own."""
    from repro_torch.core.annotations import PoppyFn
    real = PoppyFn.async_call

    async def async_call(self, *args, **kwargs):
        return str(await real(self, *args, **kwargs)) + "!"
    monkeypatch.setattr(PoppyFn, "async_call", async_call)


def text_altered(monkeypatch):
    """The backend's reading of the served tokens gains a character."""
    from repro_torch.serving.backend import LocalEngineBackend
    real = LocalEngineBackend._generate_tokens

    async def generate_tokens(self, toks, **kw):
        return "#" + await real(self, toks, **kw)
    monkeypatch.setattr(LocalEngineBackend, "_generate_tokens",
                        generate_tokens)


def outputs_swapped(monkeypatch, at=8, keep=None):
    """The dispatcher hands two calls each other's output: the ``at``-th
    call answered (past the warm-up) and the next one answered after it
    (with ``keep``, the next whose first ``keep`` characters, what a
    program keeps of an output, differ).  Both outputs are served ones,
    each at the wrong call."""
    import asyncio

    from repro_torch.dispatch import Dispatcher
    real = Dispatcher.generate
    state = {"answered": 0, "held": None}

    async def generate(self, prompt, **kw):
        out = await real(self, prompt, **kw)
        state["answered"] += 1
        if state["answered"] == at:
            fut = asyncio.get_running_loop().create_future()
            state["held"] = (out, fut)
            return await fut
        if state["held"] is not None and (
                keep is None or state["held"][0][:keep] != out[:keep]):
            held, fut = state["held"]
            state["held"] = None
            fut.set_result(out)
            return held
        return out
    monkeypatch.setattr(Dispatcher, "generate", generate)


FAULTS = {"token_altered": token_altered, "answer_altered": answer_altered,
          "text_altered": text_altered, "outputs_swapped": outputs_swapped}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, size, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run(cell, size)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda_card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_outputs_swapped_is_not_correct_on_the_card(cell, cuda_card,
                                                    monkeypatch):
    """At the cell's own sizes and vocabulary: one pair of calls handed
    each other's served output fails the runtime check.  The seeded
    weights serve many calls the same tokens, and a swap of two outputs
    alike in what a program keeps of them changes no program, so the
    pair is one that differs there."""
    mix = load_cell(cell)["mix"]
    outputs_swapped(monkeypatch, at=30,
                    keep=mix.get("summary_bytes") or mix["action_bytes"])
    out = run_cell(cell, 2**31 + 404, 8.0, False, device="cuda",
                   t_process=time.monotonic())
    assert not out["correct"], out["checks"]
    assert out["checks"]["runtime_mismatches"]["value"] > 0
