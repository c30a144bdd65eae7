"""The control of each cell's model check: the reference in fp8, put in
the program's place, reads worse than the program at the same positions.
On the CPU at tiny sizes (the program's place taken by the float32
reference decoding greedily); on the card at each cell's own size, where it
must fail the cell's limit while the program passes it (``control.py``
reads it over more seeds)."""

import json
import pathlib
import time

import pytest
import torch

from bench import check, reference, weights
from bench.harness import run_cell
from bench.tests.tiny import shrink

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
MODEL_NUMBERS = {"served_token_logit_gap": ("gap", "control_gap"),
                 "served_token_mean_gap": ("mean_gap", "control_mean_gap")}


def greedy(run, tree, prompt, n):
    """``n`` tokens the float32 reference decodes greedily after
    ``prompt``."""
    out = []
    for _ in range(n):
        seq = prompt + out
        out.append(int(reference.logits_at(run, tree, seq,
                                           [len(seq) - 1]).argmax()))
    return out


@pytest.mark.parametrize("name", ["stablelm-3b", "olmoe-1b-7b"])
def test_control_reads_worse_on_the_cpu(name):
    config = json.loads((ROOT / f"bench/configs/{name}.json").read_text())
    run, _ = shrink(config["run"], {"name": "mapreduce"})
    tree = weights.make_weights(run, 2**31 + 202, "cpu")
    g = torch.Generator().manual_seed(5)
    requests = []
    for n in (30, 45, 60):
        prompt = torch.randint(0, 256, (n,), generator=g).tolist()
        requests.append((prompt, greedy(run, tree, prompt, 12)))
    r = check.model_readings(run, tree, requests, control=True)
    assert r["gap"] == 0.0 and r["mean_gap"] == 0.0
    assert r["control_gap"] > 0.0 and r["control_mean_gap"] > 0.0
    assert r["tokens"] == 36


@pytest.mark.cuda_card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit_on_the_card(cell, cuda_card):
    limits = json.loads((ROOT / f"bench/limits/{cell}.json").read_text())
    out = run_cell(cell, 2**31 + 303, 8.0, False, device="cuda",
                   t_process=time.monotonic(), control=True)
    c = out["control"]
    compared = [n for n in MODEL_NUMBERS if n in limits]
    assert compared
    assert all(c[MODEL_NUMBERS[n][0]] <= limits[n] for n in compared)
    assert any(c[MODEL_NUMBERS[n][1]] > limits[n] for n in compared)
