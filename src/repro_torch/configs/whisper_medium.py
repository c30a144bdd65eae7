"""Whisper-medium — encoder–decoder; conv frontend stubbed (input_specs
provides precomputed 1500-frame embeddings). LayerNorm, learned positions,
no RoPE. [arXiv:2212.04356; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="enc_dec",
    num_layers=24,            # decoder blocks
    enc_layers=24,            # encoder blocks
    enc_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    norm_type="layernorm",
    use_rope=False,
    frontend="audio_stub",
)
