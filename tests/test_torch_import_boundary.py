"""The port stands alone: no module of ``src/repro_torch/``, and not
``chip_smoke.py``, imports ``jax`` or anything of the ``repro`` package
(only the tests import both)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_files_found():
    assert len(FILES) > 15
    assert all(p.exists() for p in FILES)
    # the training slice's and the serving front door's modules are
    # covered too: a missing copy fails here
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES
             if "repro_torch" in p.parts}
    for mod in ("training/optimizer.py", "training/data.py",
                "training/checkpoint.py", "training/train_loop.py",
                "training/tree.py", "training/__init__.py",
                "launch/steps.py", "launch/train.py", "launch/__init__.py",
                "core/ai.py", "durability/faults.py",
                "durability/__init__.py", "dispatch/stats.py",
                "dispatch/admission.py", "dispatch/reliability.py",
                "dispatch/router.py", "dispatch/cache.py",
                "dispatch/batcher.py", "dispatch/dispatcher.py",
                "dispatch/__init__.py", "serving/backend.py",
                "serving/fleet.py", "launch/serve.py",
                "serving/__init__.py", "sharding/rules.py",
                "sharding/placement.py", "sharding/__init__.py",
                "launch/mesh.py", "launch/dryrun.py", "configs/shapes.py",
                "training/compression.py",
                # the PopPy compiler and runtime, and the journal
                "core/__init__.py", "core/errors.py", "core/values.py",
                "core/registry.py", "core/trace.py", "core/stdlib.py",
                "core/bezoar.py", "core/frontend.py", "core/lambda_o.py",
                "core/lower.py", "core/seqeval.py", "core/batching.py",
                "core/speculate.py", "core/controllers.py",
                "core/engine.py", "core/annotations.py",
                "durability/journal.py"):
        assert mod in names, mod


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_repro_imports(path):
    bad = [(ln, mod) for ln, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.serving.engine")
    assert not _forbidden("repro_torch.models") and not _forbidden("jaxtyping_x")
