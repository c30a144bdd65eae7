"""StableLM-3B — dense decoder, full MHA-as-GQA (kv=heads), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b family; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    norm_type="layernorm",
    qkv_bias=False,
)
