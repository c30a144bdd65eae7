"""Architecture configs the port serves: the dense attention LMs, the
hybrid RG-LRU/local-attention LM and the Mamba-2 SSM."""

from . import mamba2_2_7b, qwen3_14b, recurrentgemma_9b, stablelm_3b
from .base import ModelConfig, torch_dtype  # noqa: F401

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (stablelm_3b, qwen3_14b, recurrentgemma_9b,
                      mamba2_2_7b)}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; the port has {ARCH_IDS} (MoE, "
            f"encoder-decoder and VLM wait for ROADMAP.md §A.7 and §A.9)")
    return REGISTRY[name]
