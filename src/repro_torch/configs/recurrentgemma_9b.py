"""RecurrentGemma-9B — hybrid: RG-LRU recurrent blocks + local (sliding
window) attention, repeating (rglru, rglru, attn). MQA kv=1, window 2048.
[arXiv:2402.19427; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    attn_window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
    conv_width=4,
)
