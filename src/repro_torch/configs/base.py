"""Model configuration schema (copy of ``repro/configs/base.py``).

The fields and derived properties are those of the reference dataclass,
so a config built here describes the same model; only
``activation_dtype`` returns a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (the config's dtype strings)."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | enc_dec | hybrid | ssm | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_type: str = "rmsnorm"    # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_window: int = 0          # 0 = global; >0 = sliding window
    use_rope: bool = True

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "shard_map"

    # encoder–decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 0

    # hybrid (recurrentgemma)
    block_pattern: tuple = ()
    lru_width: int = 0
    conv_width: int = 4

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128

    frontend: str = ""

    # numerics / compilation
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "xla"
    scan_layers: bool = True
    remat: str = "full"
    microbatches: int = 1
    param_strategy: str = "fsdp"
    kv_cache_dtype: str = ""
    serve_param_dtype: str = "bfloat16"
    tp_strategy: str = "auto"

    # -- derived -----------------------------------------------------------

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables padded to a multiple of 256; logits beyond
        ``vocab_size`` are masked to -1e30."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU tests: the reference's
        ``reduced()`` (float32, d_model 64; MoE configs keep 8 experts at a
        dropless capacity factor of 8.0, hybrid configs one (rglru, rglru,
        attn) super-block at lru_width 64, ssm configs drop the attention
        heads, encoder-decoder configs keep 2 encoder layers over 16
        frames)."""
        kw = dict(
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) or 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=16 if self.enc_seq else 0,
            lru_width=64 if self.lru_width else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            num_experts=8 if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2),
            # dropless at smoke scale: capacity >= any expert's load
            moe_capacity_factor=8.0 if self.num_experts else 1.25,
            dtype="float32",
            remat="none",
        )
        if self.block_pattern:
            kw["block_pattern"] = ("rglru", "rglru", "attn")
            kw["num_layers"] = 3
        if self.family == "ssm":
            kw["num_heads"] = 0
            kw["num_kv_heads"] = 0
            kw["head_dim"] = 0
        return self.replace(**kw)
