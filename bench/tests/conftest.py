"""The marker of the benchmark's tests that need a CUDA card, and its
fixture."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda_card: needs a CUDA card (the chip); skipped "
        "elsewhere")


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is there (decided here, at run
    time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")
