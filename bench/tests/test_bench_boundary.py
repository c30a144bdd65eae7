"""Nothing of ``bench/`` imports JAX or the JAX package; the reference's
files import nothing of the port; ``run.py`` refuses to run without a
card and prints no result."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: the plain reference, the weights, the comparison, the
# work counts, the profile arithmetic and the reading of served ids read
# nothing of the port
REFERENCE_FILES = {"reference.py", "weights.py", "check.py", "flops.py",
                   "profile.py", "traffic.py", "tokenizer.py"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", sorted(REFERENCE_FILES))
def test_reference_files_import_nothing_of_the_port(name):
    assert "repro_torch" not in top_level_imports(BENCH / name)


def test_the_forbidden_names_are_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "stablelm-3b.mapreduce", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_every_named_file_is_there():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert (BENCH / "mixes" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
