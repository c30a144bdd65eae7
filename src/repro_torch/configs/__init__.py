"""Architecture configs the port serves: the dense attention LMs and the
hybrid RG-LRU/local-attention LM."""

from . import qwen3_14b, recurrentgemma_9b, stablelm_3b
from .base import ModelConfig, torch_dtype  # noqa: F401

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (stablelm_3b, qwen3_14b, recurrentgemma_9b)}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port has {ARCH_IDS} (other families "
            f"wait for ROADMAP.md §A.7-A.9)")
    return REGISTRY[name]
