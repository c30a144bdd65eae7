"""Assigned input-shape sets and abstract input specs (counterpart of
``repro/configs/shapes.py``).

Four shapes per LM architecture (seq_len × global_batch):
  train_4k     4,096 × 256   — training step
  prefill_32k  32,768 × 32   — inference prefill
  decode_32k   32,768 × 128  — one decode token against a 32k KV cache
  long_500k    524,288 × 1   — long-context decode; only sub-quadratic archs

``input_specs`` returns tensors on the ``meta`` device: shapes and
dtypes, no storage (the reference's ``ShapeDtypeStruct`` stand-ins).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import ModelConfig, torch_dtype


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Is this (arch × shape) cell runnable?"""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention architecture — quadratic "
                       "attention at 524k context; run only for "
                       "SSM/hybrid archs (documented in DESIGN.md)")
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _tok(b, s):
    return _meta((b, s), torch.int32)


def _frontend(cfg, b, s):
    """The encoder frames or the VLM's patch-embedding prefix, if any."""
    if cfg.family == "enc_dec":
        return {"encoder_frames": _meta((b, cfg.enc_seq, cfg.d_model),
                                        torch_dtype(cfg.dtype))}
    if cfg.frontend == "patch_stub":
        n_patches = min(1024, s // 4)
        return {"patch_embeds": _meta((b, n_patches, cfg.d_model),
                                      torch_dtype(cfg.dtype))}
    return {}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Abstract inputs for the train, prefill and decode steps."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": _tok(b, s), "targets": _tok(b, s),
                **_frontend(cfg, b, s)}
    if shape.kind == "prefill":
        return {"tokens": _tok(b, s), **_frontend(cfg, b, s)}
    # decode: one new token against a cache of length s
    return {"tokens": _tok(b, 1), "positions": _meta((b,), torch.int32)}
