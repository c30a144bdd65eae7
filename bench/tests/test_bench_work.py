"""A program's calls, their prompt lengths in tokens and their
``max_tokens`` are a function of the seed alone: the same whatever the
model decodes."""

import asyncio
import json
import pathlib
import random

import pytest

from bench.programs import fit_text, make_programs
from bench.traffic import Traffic

MIXES = pathlib.Path(__file__).resolve().parents[1] / "mixes"


class FakeModel:
    """Answers every call with text drawn from ``rng``: any length, any
    characters (multi-byte ones among them)."""

    def __init__(self, seed):
        self.rng = random.Random(seed)
        self.calls = []

    async def generate(self, prompt, *, max_tokens, temperature=0.0,
                       stop=None, **_):
        self.calls.append((len(prompt.encode("utf-8")) + 1, max_tokens))
        await asyncio.sleep(self.rng.random() * 1e-3)
        n = self.rng.randrange(0, 3 * max_tokens)
        return "".join(self.rng.choice("ab é中\U0001f600")
                       for _ in range(n))


def calls(kind, args, seed):
    from repro_torch.core.ai import use_dispatcher
    effects = {}
    programs = make_programs(effects)
    model = FakeModel(seed)

    async def go():
        with use_dispatcher(model):
            return await programs[kind].async_call(0, *args)
    asyncio.run(go())
    return sorted(model.calls), effects[0]


@pytest.mark.parametrize("name", ["mapreduce", "agent_loop"])
def test_calls_do_not_depend_on_outputs(name):
    m = json.loads((MIXES / f"{name}.json").read_text())
    kind, args = Traffic(m, 1234).instance(3)
    one, lines_one = calls(kind, args, 1)
    two, lines_two = calls(kind, args, 2)
    assert one == two
    assert lines_one != lines_two
    n = m["fan_out"] + 1 if kind == "mapreduce" else m["turns"]
    assert len(one) == n


def test_fit_text_is_exact_in_bytes():
    for text in ("", "abc", "é" * 40, "\U0001f600" * 9, "x" * 500):
        for n in (1, 6, 48, 128):
            out = fit_text(text, n)
            assert len(out.encode("utf-8")) == n
            assert text.encode("utf-8")[:n].startswith(
                out.rstrip(".").encode("utf-8"))


def test_served_ids_read_apart():
    """Every id of the cells' vocabulary reads as its own three
    characters, so two calls served different ids read differently;
    prompts encode as the port's byte tokenizer encodes them."""
    from repro_torch.serving.tokenizer import ByteTokenizer

    from bench.tokenizer import IdTokenizer
    tok = IdTokenizer(50304)
    texts = {tok.decode([i]) for i in range(50304)}
    assert len(texts) == 50304 and {len(t) for t in texts} == {3}
    assert tok.decode([0, 63, 64, 50303]) == "000" "00_" "010" "ch_"
    assert tok.decode([300, 40000]) != tok.decode([40000, 300])
    prompt = "a prompt é"
    assert tok.encode(prompt) == ByteTokenizer(50304).encode(prompt)
