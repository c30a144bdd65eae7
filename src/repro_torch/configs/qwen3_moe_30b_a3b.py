"""Qwen3-30B-A3B — MoE decoder, 128 experts top-8, GQA kv=4, qk-norm.
d_ff=768 is the per-expert (moe) intermediate size.
[hf:Qwen/Qwen3-30B-A3B; hf-verified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
)
