"""The plain reference against the port's plain path (the CPU runs the
kernels' plain versions) on tiny presets of both configurations, in
float32; and the fp8 control well away from both."""

import json
import math
import pathlib

import pytest
import torch

from bench import reference, weights
from bench.harness import check_tree, port_config
from bench.tests.tiny import shrink

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny(name):
    config = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    run, _ = shrink(config["run"], {"name": "mapreduce"})
    return run


@pytest.mark.parametrize("name", ["stablelm-3b", "olmoe-1b-7b"])
def test_reference_matches_the_port_in_float32(name):
    from repro_torch.models import build_model
    run = tiny(name)
    cfg = port_config(run).replace(dtype="float32")
    model = build_model(cfg)
    tree = weights.make_weights(run, 2**31 + 9, "cpu", dtype=torch.float32)
    check_tree(model, tree)
    tokens = torch.randint(0, 256, (1, 40), generator=torch.Generator()
                           .manual_seed(3))
    with torch.no_grad():
        port, _ = model.forward(tree, {"tokens": tokens})
    port = port[0, :, :run["vocab_size"]]
    ref = reference.logits_at(run, tree, tokens[0].tolist(), list(range(40)))
    err = (port - ref).norm() / ref.norm()
    assert err < 1e-5, err
    ctl = reference.logits_at(run, tree, tokens[0].tolist(), list(range(40)),
                              quant="fp8")
    assert (ctl - ref).norm() / ref.norm() > 100 * err


def test_weights_repeat_from_the_seed():
    run = tiny("olmoe-1b-7b")
    a = weights.make_weights(run, 7, "cpu")
    b = weights.make_weights(run, 7, "cpu")
    c = weights.make_weights(run, 8, "cpu")
    la = weights.layer(a, 1)
    assert all(torch.equal(la["moe"][k], weights.layer(b, 1)["moe"][k])
               for k in la["moe"])
    assert not torch.equal(a["embed"], c["embed"])
    assert sum(math.prod(s) for s, _, _ in
               weights.leaf_specs(run).values()) == sum(
        v.numel() for v in [a["embed"], a["lm_head"]]) + sum(
        t.numel() for t in _leaves(a["layers"])) + sum(
        t.numel() for t in _leaves(a["final_norm"]))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_a_served_token_outside_the_vocabulary_reads_infinite():
    from bench.check import gaps
    ref = torch.tensor([[1.0, 3.0, 2.0]])
    assert gaps(ref, torch.tensor([1])).item() == 0.0
    assert gaps(ref, torch.tensor([2])).item() == 1.0
    assert gaps(ref, torch.tensor([7])).item() == float("inf")
