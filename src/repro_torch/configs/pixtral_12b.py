"""Pixtral-12B — VLM: pixtral-ViT frontend (stubbed: input_specs provides
precomputed patch embeddings) + Mistral-Nemo-style GQA decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="patch_stub",
)
