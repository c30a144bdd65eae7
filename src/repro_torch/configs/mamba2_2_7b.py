"""Mamba2-2.7B — attention-free SSM with SSD (state-space duality):
d_inner = 2·d_model = 5120, 80 heads of 64, state 128, conv width 4.
[arXiv:2405.21060; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
)
