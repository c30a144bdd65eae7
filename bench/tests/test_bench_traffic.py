"""The generator: inputs from the seed alone, the same sizes for every
seed, lengths in the mix's range."""

import json
import pathlib

import pytest

from bench.traffic import Traffic

MIXES = pathlib.Path(__file__).resolve().parents[1] / "mixes"


def mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["mapreduce", "agent_loop"])
def test_same_seed_same_inputs(name):
    a, b = Traffic(mix(name), 2**31 + 17), Traffic(mix(name), 2**31 + 17)
    assert a.warm() == b.warm()
    assert [a.instance(i) for i in range(9)] == \
        [b.instance(i) for i in range(9)]
    c = Traffic(mix(name), 2**31 + 18)
    assert [a.instance(i) for i in range(3)] != \
        [c.instance(i) for i in range(3)]


def test_mapreduce_sizes_are_the_same_for_every_seed():
    m = mix("mapreduce")
    lo, hi = m["doc_tokens"]
    block = m["clients"]

    def lengths(seed):
        t = Traffic(m, seed)
        out = []
        for i in range(block):
            kind, args = t.instance(i)
            assert kind == "mapreduce"
            instruction, docs, combine, sum_tok, sum_bytes, comb_tok = args
            assert len(docs) == m["fan_out"]
            assert len(instruction) == m["instruction_tokens"]
            assert len(combine) == m["combine_instruction_tokens"]
            assert (sum_tok, sum_bytes, comb_tok) == (
                m["summary_tokens"], m["summary_bytes"], m["combine_tokens"])
            out += [len(d) for d in docs]
        return out
    one, two = lengths(5), lengths(2**33 + 1)
    assert one != two and sorted(one) == sorted(two)
    assert min(one) == lo and max(one) == hi
    assert all(d.isascii() for d in Traffic(m, 5).instance(0)[1][1])


def test_agent_inputs_share_the_system_prompt():
    m = mix("agent_loop")
    t = Traffic(m, 99)
    prefixes = [t.instance(i)[1][0] for i in range(4)]
    system = prefixes[0][:m["system_tokens"]]
    assert all(p[:m["system_tokens"]] == system for p in prefixes)
    assert all(len(p) == m["system_tokens"] + m["task_tokens"]
               for p in prefixes)
    assert len({p[m["system_tokens"]:] for p in prefixes}) == 4
    obs = t.instance(0)[1][1]
    assert len(obs) == m["turns"] - 1
    assert all(len(o) == m["observation_tokens"] for o in obs)


def test_negative_and_large_seeds():
    for seed in (-3, 0, 2**31 + 5, 2**40):
        Traffic(mix("mapreduce"), seed).instance(0)
