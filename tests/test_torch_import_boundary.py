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


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_repro_imports(path):
    bad = [(ln, mod) for ln, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("repro") and _forbidden("repro.serving.engine")
    assert not _forbidden("repro_torch.models") and not _forbidden("jaxtyping_x")
