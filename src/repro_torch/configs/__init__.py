"""Architecture configs the port runs: the dense attention LMs, the MoE
LMs, the hybrid RG-LRU/local-attention LM, the Mamba-2 SSM, the
encoder-decoder (whisper-medium) and the VLM (pixtral-12b)."""

from . import (
    mamba2_2_7b,
    olmoe_1b_7b,
    pixtral_12b,
    qwen2_5_32b,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    stablelm_3b,
    whisper_medium,
    yi_34b,
)
from .base import ModelConfig, torch_dtype  # noqa: F401

REGISTRY = {m.CONFIG.name: m.CONFIG
            for m in (qwen3_14b, stablelm_3b, yi_34b, qwen2_5_32b,
                      qwen3_moe_30b_a3b, olmoe_1b_7b, recurrentgemma_9b,
                      mamba2_2_7b, whisper_medium, pixtral_12b)}

ARCH_IDS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    return REGISTRY[name]
