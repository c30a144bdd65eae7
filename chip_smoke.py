#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

1. build   — compile every CUDA kernel of the port from the sources in
             this checkout (``src/repro_torch/kernels/*/csrc/*.cu``), and
             print each kernel's registers, shared memory, spills and (with
             ``cuobjdump``) HMMA count; a tensor-core kernel that spills or
             has no HMMA fails.
2. kernels — each kernel against its plain PyTorch version on the card,
             at the main paths' shapes (stablelm-3b, recurrentgemma-9b,
             mamba2-2.7b and a GQA shape), in bf16 (tolerance 2e-2) and
             f32 (2e-5; the SSD chunk scan 2e-4), NaN in never-read rows
             (flash's prefix padding, decode's invalid slots) giving a
             bit-equal output, with its device time (:func:`time_ms`),
             its bound, the plain version's time and a PyTorch library
             call's time as a yardstick the port never calls (none exists
             for the two scans).  Paged decode also runs page sizes 8 and
             32, a window that starts inside a page and an empty row, with
             NaN in every pool row no kept position reads (the timed case:
             bit-equal).  The RG-LRU scan runs 2100 steps with and
             without a carried state, 37 steps, one step and two batch
             rows; the SSD scan's S = 2048 row also gives the device time
             of each of its three CUDA functions (``functions_ms``).  Its
             bound counts only the products the row's own decays leave
             nonzero (``needed_flops``), at the f32 rate and, as
             ``bound_3xtf32_ms``, at the 3xTF32 rate.  Paged decode and
             flash also run at olmoe-1b-7b's shape (16 heads of 128) and
             pixtral-12b's (32 heads over 8 of 160); flash without a
             causal mask at whisper-medium's encoder (S = T = 1500) and
             prefill cross-attention (4 rows over 1500 frames), and
             causal at its decoder's prefill self-attention (S = T = 4),
             each with NaN past the inputs' last rows giving a bit-equal
             output, and decode attention at its self cache (C = 448)
             and cross memory (C = 1500, every slot valid).  Paged
             decode and flash's prefix chunk (pad 512, 384 valid) also
             run at the tensor-parallel shards' shapes of stablelm-3b
             (16 and 8 heads of 80: ``stablelm-3b/tp2``, ``/tp4``).
3. serve   — full-width stablelm-3b (32 layers, bf16, random weights from
             a seeded generator on the card) behind the port's paged
             ServingEngine: a warmed 384-token shared prefix, then 8
             concurrent greedy requests.  Checks the outputs, that the
             path launched each kernel exactly once per layer per decode
             step / prefill chunk, and one prefill's and one decode
             step's logits against the same model run through the plain
             versions: with the whole model in float32 within 1e-4
             relative L2 error (bf16's reading is printed, not held).
             A profiled second wave, and a third under
             ``repro_torch.obs.tracing()`` (one ``decode.step`` span per
             step) with the port's critical-path report over its spans
             (segments summing to the wall time).  Then the same fan-out
             through a second engine on the same weights with
             ``kv_layout="contiguous"`` (4 slots of 1024): exact launches
             (contiguous decode attention per layer per step, flash per
             layer per chunk, no paged decode), one KV splice per
             admission, the prefix reused; its tokens'
             agreement with the paged engine's is printed.
4. serve_hybrid — full-width recurrentgemma-9b (38 blocks, bf16, seeded
             random weights) behind the contiguous ServingEngine: 8
             concurrent greedy requests with 2100 … 2 prompt tokens (the
             ring rolls at prefill and wraps in decode; the shortest is
             below the conv history), then an int8-KV engine on the same
             weights serving 4 of them, and those 4 again profiled.
             Checks exact launch counts (12 decode-attention launches
             per step, 12 flash and 26 RG-LRU scans per admission), and a
             2100-token prefill's and one decode step's logits, dense and
             int8 KV, against the plain versions with the whole model in
             float32 within 1e-4 (bf16 printed only), and a 2-token
             prompt's decode step against the full forward.
5. serve_ssm — full-width mamba2-2.7b (64 SSD blocks, bf16, seeded
             random weights) behind the contiguous ServingEngine: 8
             concurrent greedy requests with 2048 … 2 prompt tokens (a
             chunk multiple, ragged tails, one exact chunk, under one
             chunk, and two prompts at and below the conv history), then
             a profiled second wave.  Checks exact launch counts (64 SSD
             chunk scans per admission, none in decode), a 2100-token
             prefill's and the next decode step's logits against the
             plain path with the whole model in float32 within 1e-4 (bf16
             printed only), and a 2-token prompt's decode step against
             the full forward.
6. serve_moe — full-width olmoe-1b-7b (16 layers of 16 heads of 128,
             64 experts, top-8, capacity factor 1.25; 6.92 B parameters,
             bf16, seeded random weights) behind the paged ServingEngine
             with the ``serve`` phase's engine and traffic.  Checks the
             same outputs, launch counts (16 paged decode launches a step,
             16 flash launches a chunk) and decode graph, prints the
             assignments the capacity bound drops in a 256-token chunk
             and the step's byte floor (every weight but the embedding
             table: the expert products run over all 64 experts' capacity
             buffers), and holds the kernel path against the plain path
             with the whole model in float32 within 1e-4 relative L2 (bf16
             printed only) with each layer's routing recorded on both:
             where a router near-tie tips, the differing positions and
             their probability gaps are printed and the logits are held
             only before the first of them (:func:`moe_vs_plain`).
7. encdec  — full-width whisper-medium (24 encoder + 24 decoder layers,
             16 heads of 64, 1500 frames, bf16, seeded random weights) at
             the model level, as the reference runs it: 8 seeded frame
             batches, a 4-token prompt, ``Model.prefill`` at capacity 448
             and 64 greedy ``Model.decode_step`` s (eager: the engine
             refuses encoder-decoder models).  Checks exact launches
             (flash per encoder layer and per decoder self- and
             cross-attention in the prefill, decode attention per
             decoder self- and cross-attention per step), and the same
             path in float32 at full depth against the plain versions:
             logits within 1e-4 at the prefill and every step, greedy
             tokens equal (bf16 printed only).  Prints encode and prefill
             ms, the step's median, p90, byte floor and profiled device
             time by kernel.
8. serve_vlm — full-width pixtral-12b (40 layers, 32 heads over 8 of
             160, vocab 131072; 12.77 B parameters, 25.5 GB in bf16)
             behind the paged engine with ``serve``'s engine and traffic:
             the same checks as ``serve``, one prefill with 256 seeded
             patch embeddings ahead of the prompt, and float32 at full
             width and 8 layers (the whole model is 51 GB in float32)
             against the plain path within 1e-4: prefill, prefix, decode
             and the patch-embedding prefill.
9. train   — full-width stablelm-3b (16 of its 32 layers: the whole
             script's time limit; the line's ``reduced`` says so; f32
             parameters, bf16 activations, ``remat="full"``) trained by
             the port's train
             step (``repro_torch.launch.steps``) with AdamW at a constant
             lr of 1e-4 for 6 steps on one repeated 4 × 1024
             ``LMDataset(seed=0)`` batch, then a profiled seventh.
             Holds each step's launches exactly (flash twice an attention
             layer: the forward and the backward's recompute: so no
             forward took the plain version), each Function's backwards,
             every loss finite and the last below the first; a
             checkpoint of the state written and read back bit-equal;
             and the loss and every parameter gradient at 2 layers in
             float32 against the plain path within 1e-4 relative L2 per
             leaf (bf16 printed only).  Prints the step's median and p90,
             tokens/s, ``mfu`` (6·N·tokens / step / 989e12), peak memory,
             the profiled step's busy share and the device ms of its
             forward, each Function's backward and the optimizer.
10. train_ssm — the same for full-width mamba2-2.7b (32 of its 64 SSD
             blocks, as train's cut; 4 × 1024; SSD twice a block).
11. train_hybrid — the same for recurrentgemma-9b at full width, its
             depth cut to one (rglru, rglru, attn) group (the train state
             of 38 blocks would not fit one card; the line's ``reduced``
             says so), 1 × 2304 past the 2048 window (flash twice, the
             RG-LRU scan three times a block: its backward is the
             kernel's scan over reversed time), the check at 3 blocks.
12. serve_fleet — full-width stablelm-3b (bf16, seeded random weights,
             one set of parameters shared by every replica) behind the
             port's ``EngineFleet`` with fig15's traffic: 4 sessions × 4
             queries sharing a 160-token session prefix, 16 new greedy
             tokens, 4 slots a replica, an untimed priming wave (one
             query a session), then a timed wave of the 16 requests
             dispatched one each, concurrently, through
             ``fleet.dispatcher.generate``; three fleets: one replica,
             4 replicas under ``prefix_affinity`` and 4 under
             ``least_outstanding``.  Holds every request's tokens to one
             ``ServingEngine``'s on the path it took (over the primed
             prefix, or prefilled whole: the paths round bf16
             differently; a fleet whose every request routed warm must
             give the warm path's tokens exactly), one replica's warm
             share (``prefix_hits / prefix_probed``) at 1 (it holds all
             four sessions), affinity's strictly above
             least-outstanding's, each replica's decode graph, exact
             launches over all replicas (paged decode a layer a step,
             flash a layer a chunk), and that one ``generate_batch`` wave
             under the port's ``use_dispatcher`` lands its prefix-batch
             counts on the fleet's stats.  Prints each fleet's drain
             seconds and their ratio to one replica's, the warm shares,
             each replica's ``engine_stats()``, the peak memory and the
             busy share of a profiled wave.
13. train_moe — ``train``'s checks for olmoe-1b-7b at full width, its
             depth cut to 2 of 16 layers (1.05 B parameters; all 16 need
             ~111 GB of train state), 4 × 1024 (flash twice a layer).
             The gradient check records each MoE call's routing on both
             paths: a batch where a router near-tie tips a token's top-8
             set is reported and the next tried
             (:func:`moe_grads_vs_plain`).  ``mfu`` counts the experts'
             weights at top-k / experts.
14. train_encdec — the same for whisper-medium whole (24 + 24 layers,
             758 M parameters): 4 × 1500 seeded frames and decoder
             sequences of 448 tokens (flash twice an encoder layer and
             four times a decoder layer: self- and cross-attention, each
             with its recompute), the check at 2 + 2 layers; ``mfu``
             counts the encoder and the cross K/V projections over the
             frames.
15. serve_tp — full-width stablelm-3b (bf16, the serve phase's seeded
             weights and traffic) behind the paged engine at tp = 1, 2
             and 4, every shard on this card (``make_serving_mesh(tp,
             devices=["cuda"] * tp)``: the cost of splitting, not scale
             out).  Each shard runs the paged decode and flash kernels on
             its own 32/tp heads.  Prints tokens agreeing with tp = 1,
             the max abs difference of a prefill's last logits, decode
             step ms (median, p90), prefill chunk ms, launches by shape
             (exact: tp per layer per step / chunk) and each shard's pool
             bytes, held to ``serving_kv_estimate`` / tp.  Then the same
             at full width in float32 with the depth cut to 4 layers:
             greedy tokens must equal tp = 1's exactly.
16. ef_allreduce — the int8 error-feedback compressed mean over a
             ``data`` axis of 2 shards on this card, over full-width
             stablelm-3b's gradient trees of two train-step batches (4 ×
             1024 each, float32), all leaves but the MLP's three
             (``EF_VALUE_BUDGET``: the outputs of two calls over all 2.8 B
             values would not fit beside the inputs): max abs error
             against the exact mean, the residual's norm, ``wire_bytes``
             against 4 B a value, and ms a call (the second, with the
             first call's errors fed back).
18. train_tp — the sharded train step (``make_train_step(model,
             optimizer, mesh)``: FSDP over ``data``, the rules' model
             split, one controller) with every coordinate on this card,
             bf16 activations, f32 parameters, ``remat="full"``, the
             ``train`` phase's data and AdamW: stablelm-3b at full width
             (the heads layout), its depth cut to 8 of 32 layers, at
             meshes (1, 1), (2, 1), (1, 2) and (2, 2); qwen3-14b at full
             width cut to 2 of 40 layers at (1, 16), where ``make_rules``
             picks ``ulysses_sp`` (40 heads do not split 16 ways).  Per
             mesh: step median and p90, loss and gradients (relative L2)
             against the (1, 1) step's, flash launches a step held to dp
             × tp × layers × 2 (forward and remat recompute), the
             collectives by kind and the peak memory of the steps (and,
             apart, of placing the state).  Then float32 at 2
             layers: loss and gradients held to the (1, 1) step's within
             ``TRAIN_TP_TOL_F32``.
19. train_tp_layouts — the sharded train step in the layouts
             ``train_tp`` does not reach (:data:`TP_LAYOUTS`), at full
             width and cut depth (2 layers, 3 for one rglru/rglru/attn
             group, 2 + 2 for whisper-medium): ``ulysses_sp`` picked by
             ``make_rules`` at (1, 3) for recurrentgemma-9b (B 1, S 2304:
             shard 2's window reaches back across the shard boundary),
             olmoe-1b-7b (B 4, S 1020, which splits three ways: MoE
             routed over the row's whole token set) and
             whisper-medium (B 4, 1500 frames split, the decoder's 448
             positions whole on every shard); stablelm-3b
             under ``ulysses`` and ``heads_sp`` at (1, 2), ZeRO-2 at (2,
             1) and ``zero2_master`` at (2, 2); ``heads`` with the
             replicated layouts: recurrentgemma-9b, mamba2-2.7b and
             whisper-medium at (1, 3), qwen3-14b at (1, 5).  Each holds,
             in float32, the loss and every gradient leaf to the
             one-device step's within ``TRAIN_TP_TOL_F32`` and every
             replica of a slice to one gradient.  The three ulysses_sp
             cases and ZeRO-2 also run three bf16 steps on (1, 1) and on
             their mesh: the step time against (1, 1)'s, flash launches a
             step held exactly, the collectives by kind, the peak memory,
             and every slice held more than once bit-equal across its
             holders after the steps.  Then qwen3-14b's ulysses_sp decode
             step at (1, 2) over a cache split by KV heads, its logits
             against the one-device step's.
20. poppy_apps — compound-AI programs written against the port's own
             ``@poppy`` (``repro_torch.core``), through a port
             ``Dispatcher`` (admission at 8) and ``LocalEngineBackend``
             into the paged engine at full-width stablelm-3b in bf16
             (``serve``'s engine, prefix cache off), a fresh engine a
             run, each warmed by one untimed request: A, 8 independent
             summaries reported in order and a combine
             (``examples/serve_llm.py``); B, the 5-agent, 3-round debate
             with a memory domain an agent
             (``examples/multi_agent_debate.py``); C, A on the blocking
             client offloaded to threads, the engine on the bridge loop,
             plus one pure-Python external in a worker process.  A and B
             under standard Python and under PopPy must give equal
             results, report lines, memories and greedy tokens call for
             call, ≡_A traces and decode occupancy 1 against 8 and 5; C
             must equal A's PopPy run and its process external the plain
             call; A under ``batching()`` with the prefix cache on must
             run the backend's shared-prefix warm.  Every run holds
             exact launches (paged decode a layer a step, flash a layer
             a chunk) and the decode graph.  Prints each run's wall
             seconds, decode steps and their median, occupancy and the
             time outside external calls, a traced PopPy run of A (one
             tracer holding the runtime's and the engine's spans, with
             the critical path) and its busy share under the profiler.

The kernels phase also holds each trained wrapper's
``torch.autograd.Function`` on the card at these phases' shapes: flash
(bf16 and f32), the RG-LRU scan and the SSD scan, the forward against
the plain version and the backward against autograd through it (flash's
and SSD's backwards recompute through the plain version, so there the
forward holds the kernel and the backward the wiring), with the
backward's device time beside its bound, the plain version's and, for
flash, the backward of one SDPA call (:func:`backward_kernel_rows`);
the SSD forward there is also held beside the plain version against a
float64 step recurrence (``forward_vs_float64``).  Flash's forward runs
at the train phases' shapes too, in bf16, with its bound and SDPA's
time (:func:`train_flash_rows`), and at train_tp_layouts' sequence
shards: the windowed prefix form and the encoder's non-causal shard
(:func:`layout_flash_rows`).

Every serve engine replays its decode step as one CUDA graph, captured
after the eager first step.  Each serve phase checks, per engine, one
capture and a replay for every later step, each replay counting one
eager step's launches (``graph``), and holds one replay against one
eager step on a clone of the engine's state: logits and every updated
tensor bit-equal (``graph.vs_eager``).

Float32 matmuls and convolutions run in full float32 here:
``allow_tf32`` is switched off for both cuBLAS and cuDNN, so the f32
comparisons are not blurred by TF32's ~3 decimal digits.

Every failed check raises and the script exits non-zero.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit from nvidia-smi, and the one before that the
``{"kernels": [...]}`` summary (each kernel's main-path row, and all its
rows, each with the launches the main paths made at its launch key: the
wrappers count launches in all and by key, and a ``launches_by_shape``
line prints each phase's table).  Without a GPU (or
without the repo's ``src/`` beside this file) it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PHASES = ("build", "kernels", "serve", "serve_hybrid", "serve_ssm",
          "serve_moe", "encdec", "serve_vlm", "train", "train_ssm",
          "train_hybrid", "serve_fleet", "train_moe", "train_encdec",
          "serve_tp", "ef_allreduce", "serve_tp_families",
          "serve_tp_fallbacks", "train_tp", "train_tp_layouts",
          "poppy_apps")

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak and
# the float32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# the float32 exponential of a log below ln 2^-150 rounds to 0
LOG_F32_UNDERFLOW = math.log(2.0 ** -150)
# the TF32 tensor-core peak; the SSD scan's 3xTF32 form runs three TF32
# products for each float32 one
TF32_FLOPS = 495e12
# kernel timing: inputs under the 50 MB L2 are cloned until the copies
# exceed it, at most MAX_COPIES of them, so that the timed calls (a few
# launches each) stay within the card's launch queue of ~1,000 entries
# (the SSD rows at S = 2 and 120 reach the cap; their 2.6 MB output state
# per call still churns the L2 between two uses of a copy); the spin
# kernel queued ahead of the timed calls runs at up to ~2 GHz (the
# H100's boost clock)
L2_BYTES = 50 * 10**6
MAX_COPIES = 128
SPIN_CYCLES_PER_S = 2e9
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the SSD chunk scan sums 128-term f32 products over 128-step chunks in
# another order than its plain version: the tolerance of the reference's
# own SSD test (tests/test_kernels.py)
SSD_TOL = 2e-4
# serve phase, whole model in float32: relative L2 error of the kernel
# path's logits against the plain path's
LOGITS_TOL_F32 = 1e-4

REPLACES = {
    "paged_decode_attention":
        "src/repro/kernels/paged_attention/kernel.py:71",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:91",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:63",
    "decode_attention_int8":
        "src/repro/kernels/decode_attention/kernel.py:143",
    "rglru_scan": "src/repro/kernels/rglru/kernel.py:47",
    "ssd_chunk_scan": "src/repro/kernels/ssd/kernel.py:69",
    # the split-K parts of the two decode kernels, under a cache split by
    # sequence: the partial entries and their merge
    "decode_attention_partial":
        "src/repro/kernels/decode_attention/kernel.py:63",
    "decode_attention_int8_partial":
        "src/repro/kernels/decode_attention/kernel.py:143",
    "decode_combine": "src/repro/kernels/decode_attention/kernel.py:63",
}
SOURCES = {
    "paged_decode_attention":
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "decode_attention":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "decode_attention_int8":
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
    "rglru_scan": "src/repro_torch/kernels/rglru/csrc/rglru.cu",
    "ssd_chunk_scan": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
    **{n: "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
       for n in ("decode_attention_partial", "decode_attention_int8_partial",
                 "decode_combine")},
}
# the CUDA functions of the port's kernels, as the profiler names them
PORT_KERNEL_FUNCS = ("paged_decode_kernel", "paged_mma_kernel",
                     "flash_fwd_kernel", "flash_mma_kernel",
                     "decode_partial_kernel", "decode_mma_kernel",
                     "decode_int8_mma_kernel", "decode_combine_kernel",
                     "rglru_tile_scan_kernel", "ssd_state_mma_kernel",
                     "ssd_pass_kernel", "ssd_out_mma_kernel")
# wrappers that launch more than one CUDA function a call: the profile
# reports their device time a call as the sum over those functions
WRAPPER_FUNCS = {"ssd_chunk_scan": ("ssd_state_mma_kernel", "ssd_pass_kernel",
                                    "ssd_out_mma_kernel")}
# the kernels phase row that stands for each kernel in the summary line:
# its main path's shape, in the serving dtype
SUMMARY_CASE = {
    "paged_decode_attention": dict(shape="stablelm-3b", dtype="bfloat16"),
    "flash_attention": dict(shape="stablelm-3b", dtype="bfloat16",
                            prefix_pad=512),
    "decode_attention": dict(shape="recurrentgemma-9b", dtype="bfloat16"),
    "decode_attention_int8": dict(shape="recurrentgemma-9b",
                                  dtype="bfloat16"),
    "rglru_scan": dict(shape="recurrentgemma-9b", dtype="float32",
                       B=1, S=2100, h0=False),
    "ssd_chunk_scan": dict(shape="mamba2-2.7b", dtype="float32", S=2048,
                           h0=False, decay="init"),
    "decode_attention_partial": dict(shape="recurrentgemma-9b/tp2",
                                     dtype="bfloat16"),
    "decode_attention_int8_partial": dict(shape="recurrentgemma-9b/tp2",
                                          dtype="bfloat16"),
    "decode_combine": dict(shape="recurrentgemma-9b/tp2", dtype="bfloat16"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def call_ms(fn, *, warmup=3, reps=25):
    """Median milliseconds of ``fn()`` over ``reps`` runs, one CUDA event
    pair around each: the host work before each launch is counted too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rotations(args):
    """``args`` and as many clones of its tensors as it takes for all of
    them together to exceed the L2 cache, so that a launch over one copy
    finds it evicted by the launches over the others, as the serve path
    finds its KV cache; just ``[args]`` where they exceed it already."""
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    n = 1 if nbytes >= L2_BYTES else min(MAX_COPIES,
                                         L2_BYTES // max(nbytes, 1) + 2)
    return [tuple(args)] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(n - 1)]


def time_ms(fn, args, *, reps=20, repeats=3):
    """Device milliseconds of one ``fn(*args)``: one CUDA event pair around
    N = max(reps, copies) back-to-back calls over the rotating copies of
    ``args``, divided by N; the median of ``repeats`` such readings.  A
    spin kernel queued first keeps the card busy while the host enqueues
    all N calls, so the wrappers' host work is not in the reading.
    → (ms, queued_ahead): the latter is False if the card reached the
    first event before the host had enqueued the last call."""
    copies = rotations(args)
    n = max(reps, len(copies))
    t0 = time.perf_counter()
    for i in range(n):                      # warm-up over every copy
        fn(*copies[i % len(copies)])
    torch.cuda.synchronize()
    spin = int(2 * (time.perf_counter() - t0) * SPIN_CYCLES_PER_S)
    readings, ahead = [], True
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for i in range(n):
            fn(*copies[i % len(copies)])
        end.record()
        ahead = ahead and not start.query()
        end.synchronize()
        readings.append(start.elapsed_time(end) / n)
    del copies
    return statistics.median(readings), ahead


def kernel_times(fn, ref_fn, lib_fn, args):
    """A kernel row's times over ``args``: the kernel's device time
    (``ms``) and its old single-call reading with the wrapper's host work
    (``call_ms``), its plain version's and the library call's (``None``
    for no library call) device times, the library call's single-call
    reading, and for each device reading whether its calls were queued
    ahead of the card (a plain version of thousands of small launches
    fills the launch queue, and then reads host time)."""
    ahead = {}
    ms, ahead["ms"] = time_ms(fn, args)
    plain_ms, ahead["plain_ms"] = time_ms(ref_fn, args)
    row = dict(ms=ms, call_ms=call_ms(lambda: fn(*args)), plain_ms=plain_ms,
               library_ms=None, library_call_ms=None)
    if lib_fn is not None:
        row["library_ms"], ahead["library_ms"] = time_ms(lib_fn, args)
        row["library_call_ms"] = call_ms(lambda: lib_fn(*args))
    row["queued_ahead"] = ahead
    return row


def function_times(fn, args, funcs, *, reps=10):
    """Device ms a call of each CUDA function in ``funcs`` that ``fn(*args)``
    launches, from ``torch.profiler`` over ``reps`` calls; None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    hits = by_function(device_rows(prof), funcs)
    return {f: dev / 1e3 / reps for f, (dev, _) in hits.items()} or None


def device_rows(prof):
    """(device µs, count, name) of each CUDA entry of a profile that took
    device time, the most first.  The train phases' ``record_function``
    ranges (``TRAIN_RANGE...``), which the profiler also lists as device
    entries spanning their kernels, are left out: their kernels are
    rows of their own."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.key.startswith(TRAIN_RANGE):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:                      # older profilers
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def by_function(rows, funcs):
    """{f: (device µs, launches)} summed over the ``device_rows`` whose name
    holds f, for each f of ``funcs`` that some row holds."""
    out = {}
    for dev, cnt, key in rows:
        f = next((f for f in funcs if f in key), None)
        if f is not None:
            d, n = out.get(f, (0.0, 0))
            out[f] = (d + dev, n + cnt)
    return out


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: build


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    ptxas = "\n".join(f"== {n}\n{v['ptxas']}"
                      for n, v in _build.BUILD_LOG.items())
    (OUT_DIR / "ptxas.txt").write_text(ptxas)
    spills = [ln.strip() for ln in ptxas.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")
              and " 0 bytes spill stores, 0 bytes spill loads" not in ln]
    cuobjdump = _build.tool("cuobjdump")
    resources = {}
    for name, info in _build.BUILD_LOG.items():
        hmma = hmma_counts(cuobjdump, libs[name]) if cuobjdump else {}
        resources[name] = [{**r, "hmma": hmma.get(r["mangled"])}
                           for r in ptxas_resources(info["ptxas"])]
        for r in resources[name]:
            del r["mangled"]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "spill_lines": spills[:8],
          "cuobjdump": cuobjdump or "missing: HMMA counts not checked",
          "kernels": resources})
    # the tensor-core kernels: no spills, and HMMA in their SASS
    for name, rs in resources.items():
        for r in rs:
            if "mma_kernel" not in r["kernel"]:
                continue
            if r["spill_bytes"]:
                fail(f"{name}: {r['kernel']} spills {r['spill_bytes']} bytes")
            if cuobjdump and not r["hmma"]:
                fail(f"{name}: {r['kernel']} has no HMMA instruction")


def ptxas_resources(text):
    """Per kernel entry of an ``nvcc -Xptxas -v`` report: registers,
    static shared memory, spill bytes (stores + loads) and its name,
    demangled and cut at its argument list."""
    import re
    rows, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"mangled": m.group(1), "registers": None,
                   "smem_bytes": 0, "spill_bytes": 0}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ln)
            if m:
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                cur["smem_bytes"] = int(m.group(1)) if m else 0
    names = demangle([r["mangled"] for r in rows])
    for r, n in zip(rows, names):
        r["kernel"] = strip_arguments(n)
    return rows


def strip_arguments(name):
    """A demangled kernel name without its return type, namespace and
    argument list: ``flash_mma_kernel<(int)256>``."""
    name = name.replace("(anonymous namespace)::", "").replace(
        "<unnamed>::", "").removeprefix("void ")
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def demangle(names):
    from repro_torch.kernels import _build
    filt = _build.tool("cu++filt") or _build.tool("c++filt")
    if not filt or not names:
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def hmma_counts(cuobjdump, lib):
    """{mangled kernel name: HMMA instructions in its SASS}."""
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :")[1].strip()
            counts[cur] = 0
        elif cur is not None and "HMMA" in ln:
            counts[cur] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def paged_case(gen, *, B, H, KVH, d, ps, N, dtype, lengths):
    """Page pool with scratch page 0 and shuffled tables; the last row is
    a retired slot (table all page 0, stale length)."""
    P = B * N + 1
    dev = "cuda"
    q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(P, ps, KVH, d, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, ps, KVH, d, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[: B * N] + 1
    table = perm.reshape(B, N).to(torch.int32)
    table[-1] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, lens


def paged_kv_keys(table, lengths, ps, window=0):
    """Distinct pool rows (page * ps + offset) that the kept positions
    ``[max(0, len - window), min(len, N * ps))`` reach through the page
    table: the rows the function must read, each once.  A retired row
    (table all page 0) reaches at most the scratch page."""
    t = table.cpu().numpy().astype(np.int64)
    keys = []
    for b, n in enumerate(lengths):
        start = max(0, n - window) if window > 0 else 0
        pos = np.arange(start, min(n, t.shape[1] * ps))
        keys.append(t[b, pos // ps] * ps + pos % ps)
    return np.unique(np.concatenate(keys))


def paged_nan_elsewhere(kp, vp, table, lengths, window=0):
    """Copies of the pools with NaN in every row no kept position reads
    (stale pages, positions before the window, unused pages)."""
    P, ps = kp.shape[:2]
    unread = torch.ones(P * ps, dtype=torch.bool)
    unread[torch.from_numpy(paged_kv_keys(table, lengths, ps, window))] = False
    unread = unread.to(kp.device)
    out = []
    for t in (kp, vp):
        t = t.clone()
        t.view(P * ps, *t.shape[2:])[unread] = float("nan")
        out.append(t)
    return out


def check_paged_cases(gen, sname, sh, dname, dtype, out, args):
    """The paged kernel beyond the timed row: NaN in every unread pool
    row of the timed case must give its output bit for bit, and page
    sizes 8 and 32 (a 64-position tile spans 8 or 2 pages) and a window
    that starts inside a page, over lengths with an empty row, must agree
    with the plain version, each with NaN in its unread rows.  → the
    cases' errors."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    q, kp, vp, table, lens = args
    lengths = lens.tolist()
    if not torch.equal(pa_ops.paged_decode_attention(
            q, *paged_nan_elsewhere(kp, vp, table, lengths), table, lens),
            out):
        fail(f"paged {sname} {dname}: NaN in unread pool rows changed the "
             f"output")
    cases = []
    lengths2 = [1000, 0, 513, 257, 65, 64, 3, 600]   # last: retired slot
    for ps, N, window in ((8, 128, 0), (32, 32, 0), (16, 64, 300)):
        q, kp, vp, table, lens = paged_case(
            gen, B=len(lengths2), ps=ps, N=N, dtype=dtype, lengths=lengths2,
            **sh)
        label = f"paged {sname} {dname} ps={ps} window={window}"
        kn, vn = paged_nan_elsewhere(kp, vp, table, lengths2, window)
        err = check_close(label, pa_ops.paged_decode_attention(
            q, kn, vn, table, lens, window=window),
            paged_decode_attention_ref(q, kp, vp, table, lens,
                                       window=window), dname)
        cases.append(dict(ps=ps, N=N, window=window, lengths=lengths2,
                          max_abs_err=err))
    return cases


def check_close(name, out, ref, dtype, tol=None):
    err = (out.float() - ref.float()).abs().max().item()
    tol = tol or TOL[dtype]
    finite = bool(torch.isfinite(out.float()).all())
    ok = finite and bool(torch.allclose(out.float(), ref.float(),
                                        rtol=tol, atol=tol))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err}, tol {tol}, finite {finite})")
    return err


def phase_kernels():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)

    check_flash_tile_plan()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = {"stablelm-3b": dict(H=32, KVH=32, d=80),
              "gqa-40:8": dict(H=40, KVH=8, d=128),
              "olmoe-1b-7b": dict(H=16, KVH=16, d=128),
              "pixtral-12b": dict(H=32, KVH=8, d=160),
              **SHARD_SHAPES}
    results = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for sname, sh in shapes.items():
            H, KVH, d = sh["H"], sh["KVH"], sh["d"]
            # the shards' shapes: the timed row and the prefix chunk only
            shard = sname in SHARD_SHAPES
            results.append(paged_row(gen, sname, sh, dname, dtype,
                                     cases=not shard))
            emit({"phase": "kernels", **results[-1]})

            # -- flash, exact causal and with a padded prefix: ragged, and
            #    with no valid row
            S = 256
            for pad, plen in ((512, 384),) if shard else (
                    (0, 0), (512, 384), (512, 0)):
                T = pad + S
                q = torch.randn(1, S, H, d, generator=gen,
                                device="cuda").to(dtype)
                k = torch.randn(1, T, KVH, d, generator=gen,
                                device="cuda").to(dtype)
                v = torch.randn(1, T, KVH, d, generator=gen,
                                device="cuda").to(dtype)
                if pad:   # padding rows hold zeros, as the engine pads
                    k[:, plen:pad] = 0
                    v[:, plen:pad] = 0
                kw = dict(causal=True, prefix_pad=pad, prefix_len=plen)
                label = f"flash {sname} pad={pad} plen={plen} {dname}"
                out = fa_ops.flash_attention(q, k, v, **kw)
                ref = flash_attention_ref(q, k, v, **kw)
                err = check_close(label, out, ref, dname)
                if pad:
                    check_flash_padding_nan(label, q, k, v, kw, out)
                keep = keep_mask(S, T, prefix_pad=pad, prefix_len=plen,
                                 device="cuda")
                # K/V rows some query keeps: prefix padding is never read
                rows = int(keep.any(0).sum().item())
                b_ms, b_by = bound(*fa_ops.flash_attention_work(q, k, **kw),
                                   dname)
                results.append(dict(
                    kernel="flash_attention", shape=sname, dtype=dname,
                    S=S, T=T, H=H, KVH=KVH, d=d, prefix_pad=pad,
                    prefix_len=plen, kv_rows=rows, max_abs_err=err,
                    launch_key=dict(fa_ops.launch_key(q, k, **kw)),
                    tol=TOL[dname], **flash_times(kw, keep, (q, k, v)),
                    bound_ms=b_ms, bound_by=b_by))
                emit({"phase": "kernels", **results[-1]})
    for row in (hybrid_kernel_rows(gen) + ssd_kernel_rows(gen)
                + encdec_kernel_rows(gen) + train_flash_rows(gen)
                + backward_kernel_rows(gen) + tp_family_kernel_rows(gen)
                + fallback_kernel_rows(gen) + ulysses_flash_rows(gen)
                + layout_flash_rows(gen)):
        results.append(row)
        emit({"phase": "kernels", **row})
    return results


def paged_row(gen, sname, sh, dname, dtype, *, cases=True):
    """The paged decode kernel against its plain version at shape ``sh``
    (H, KVH, d; with ``pool_kvh`` and ``kv_lo`` a view of KV heads
    ``[kv_lo, kv_lo + KVH)`` of a pool of ``pool_kvh``) over the kernels
    phase's pool (B = 8, 16-row pages, 64 table entries, ragged lengths
    and a retired slot), with its times,
    bound and library call (a gather of the pages and SDPA); with
    ``cases`` the checks beyond the timed row
    (:func:`check_paged_cases`)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    H, KVH, d = sh["H"], sh["KVH"], sh["d"]
    lo = sh.get("kv_lo", 0)
    B, ps, N = 8, 16, 64
    lengths = [1024, 777, 512, 300, 129, 64, 1, 600]   # last: retired slot
    q, kp, vp, table, lens = paged_case(
        gen, B=B, ps=ps, N=N, dtype=dtype, lengths=lengths, H=H,
        KVH=sh.get("pool_kvh", KVH), d=d)
    # a run of the pool's heads: a view the kernel reads in place
    kp, vp = kp[:, :, lo:lo + KVH], vp[:, :, lo:lo + KVH]
    args = (q, kp, vp, table, lens)
    out = pa_ops.paged_decode_attention(*args)
    ref = paged_decode_attention_ref(*args)
    err = check_close(f"paged {sname} {dname}", out, ref, dname)

    def sdpa_paged(q, kp, vp, table, lens, KVH=KVH, d=d):
        idx = table.long()
        k = kp[idx].reshape(B, N * ps, KVH, d).transpose(1, 2)
        v = vp[idx].reshape(B, N * ps, KVH, d).transpose(1, 2)
        valid = torch.arange(N * ps, device="cuda")[None] \
            < lens[:, None]
        return sdpa(q.transpose(1, 2), k, v, valid[:, None, None])

    more = check_paged_cases(gen, sname, sh, dname, dtype, out, args) \
        if cases else []
    toks = sum(min(x, N * ps) for x in lengths)
    rows = int(paged_kv_keys(table, lengths, ps).size)
    b_ms, b_by = bound(*pa_ops.paged_decode_attention_work(
        q, kp, table, tokens=toks, kv_rows=rows), dname)
    return dict(
        kernel="paged_decode_attention", shape=sname, dtype=dname,
        B=B, H=H, KVH=KVH, d=d, ps=ps, lengths=lengths,
        launch_key=dict(pa_ops.launch_key(q, kp, table)),
        kv_rows=rows, max_abs_err=err, tol=TOL[dname],
        **kernel_times(pa_ops.paged_decode_attention,
                       paged_decode_attention_ref, sdpa_paged, args),
        bound_ms=b_ms, bound_by=b_by, chunk=pa_ops.CHUNK,
        nan_unread_bit_equal=True,
        more_cases=more)


def check_flash_tile_plan():
    """The wrapper's tile plan (what the CPU tests hold under 227 KB)
    must give the shared memory the CUDA source asks for, at the served
    head dims."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    lib = _build.load("flash_attention", fa_ops._SIGNATURES)
    plan = {}
    for dtype, code in fa_ops._DTYPES.items():
        for d in (64, 80, 128, 160, 256):
            want = fa_ops.tile_plan(d, dtype)[2]
            got = lib.flash_attention_smem_bytes(code, d)
            if got != want:
                fail(f"flash tile plan d={d} {dtype}: the wrapper plans "
                     f"{want} bytes of shared memory, the kernel asks {got}")
            plan[f"{str(dtype)[6:]} d={d}"] = got
    emit({"phase": "kernels", "flash_smem_bytes": plan})


def flash_times(kw, keep, args):
    """:func:`kernel_times` of flash with the mask arguments ``kw``; the
    library call is SDPA with the same mask as a boolean matrix (``keep``;
    None: no mask)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    return kernel_times(
        lambda q, k, v: fa_ops.flash_attention(q, k, v, **kw),
        lambda q, k, v: flash_attention_ref(q, k, v, **kw),
        lambda q, k, v: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), keep), args)


def check_flash_padding_nan(label, q, k, v, kw, out):
    """Prefix padding rows (``prefix_len <= j < prefix_pad``) are never
    attended: NaN there must give the output computed over zeros there,
    bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    plen, pad = kw["prefix_len"], kw["prefix_pad"]
    kn, vn = k.clone(), v.clone()
    kn[:, plen:pad] = float("nan")
    vn[:, plen:pad] = float("nan")
    if not torch.equal(fa_ops.flash_attention(q, kn, vn, **kw), out):
        fail(f"{label}: NaN in the prefix padding rows changed the output")


def sdpa(q, k, v, mask):
    """One PyTorch call computing grouped-query attention: q [B,H,S,d],
    k/v [B,KVH,T,d], boolean keep mask.  ``enable_gqa`` where this
    PyTorch has it, else K/V repeated to H heads first."""
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    except TypeError:
        G = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1),
            attn_mask=mask)


def ring_valid(positions, C, device="cuda"):
    """[B, C] validity of a ring cache of C slots holding the positions up
    to ``positions`` (the reference's ``(j <= pos) | (pos >= C)``)."""
    pos = torch.tensor(positions, device=device)[:, None]
    j = torch.arange(C, device=device)[None, :]
    return (j <= pos) | (pos >= C)


def decode_kernel_row(gen, kname, sname, sh, dname, dtype, **label):
    """Contiguous decode attention (``kname``: dense or int8 K/V) against
    its plain version at shape ``sh`` (H, KVH, d, cache length C and the
    batch rows' positions ``pos``: a ring cache's validity; None: every
    slot valid), NaN in the invalid slots giving the same output bit for
    bit, with its times and bound.  ``label`` goes into the row."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_int8_ref, decode_attention_ref)
    from repro_torch.models.attention import dequantize_kv, quantize_kv

    dev = "cuda"
    H, KVH, d, C = sh["H"], sh["KVH"], sh["d"], sh["C"]
    if sh["pos"] is None:
        B = sh["B"]
        valid = torch.ones(B, C, dtype=torch.bool, device=dev)
    else:
        B = len(sh["pos"])
        valid = ring_valid(sh["pos"], C)
    q = torch.randn(B, 1, H, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, C, KVH, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, C, KVH, d, generator=gen, device=dev).to(dtype)
    n_valid = int(valid.sum().item())
    if kname == "decode_attention":
        args = (q, k, v, valid)
        fn, ref_fn = da_ops.decode_attention, decode_attention_ref
    else:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        args = (q, k8, v8, ks, vs, valid)
        fn = da_ops.decode_attention_int8
        ref_fn = decode_attention_int8_ref
    name = " ".join([kname, sname, *map(str, label.values()), dname])
    out = fn(*args)
    err = check_close(name, out, ref_fn(*args), dname)
    # stale slots may hold anything: NaN there must not reach out
    poisoned = [a.clone() for a in args]
    if kname == "decode_attention":
        for t in poisoned[1:3]:
            t[~valid] = float("nan")
    else:
        for t in poisoned[3:5]:      # NaN scales poison the rows
            t[~valid] = float("nan")
    if not torch.equal(fn(*poisoned), out):
        fail(f"{name}: NaN in invalid slots changed the output")

    def library(q, k, v, *rest, dtype=dtype):
        valid = rest[-1]
        if rest[:-1]:                      # int8: scales
            k = dequantize_kv(k, rest[0], dtype)
            v = dequantize_kv(v, rest[1], dtype)
        return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), valid[:, None, None, :])

    b_ms, b_by = bound(*da_ops.decode_attention_work(
        q, k, n_valid, int8=kname != "decode_attention"), dname)
    return dict(
        kernel=kname, shape=sname, **label, dtype=dname, B=B, H=H, KVH=KVH,
        d=d, C=C, positions=sh["pos"], valid_rows=n_valid,
        launch_key=dict(da_ops.launch_key(q, k)),
        max_abs_err=err, tol=TOL[dname],
        **kernel_times(fn, ref_fn, library, args), bound_ms=b_ms,
        bound_by=b_by)


def hybrid_kernel_rows(gen):
    """The recurrentgemma-9b path's kernels against their plain versions:
    decode attention (dense and int8) at its ring cache and one GQA /
    stablelm-3b shape, the RG-LRU scan at a 2100-token prefill, and flash
    at that prefill's windowed MQA shape (d = 256)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)

    dev = "cuda"
    rows = []
    # cache positions of the serve_hybrid decode batch (prompt + 31): the
    # first two rows have wrapped the 2048-slot ring
    rg_pos = [2130, 2060, 1530, 730, 330, 150, 70, 32]
    shapes = {
        "recurrentgemma-9b": dict(H=16, KVH=1, d=256, C=2048, pos=rg_pos),
        "gqa-40:8": dict(H=40, KVH=8, d=128, C=1024,
                         pos=[1023, 777, 512, 300, 129, 64, 1, 600]),
        "stablelm-3b": dict(H=32, KVH=32, d=80, C=1024,
                            pos=[1023, 777, 512, 300, 129, 64, 1, 600]),
    }
    cases = [("decode_attention", "recurrentgemma-9b"),
             ("decode_attention", "gqa-40:8"),
             ("decode_attention_int8", "recurrentgemma-9b"),
             ("decode_attention_int8", "stablelm-3b")]
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for kname, sname in cases:
            rows.append(decode_kernel_row(gen, kname, sname, shapes[sname],
                                          dname, dtype))

        # flash at the hybrid prefill: S = T = 2100, MQA, d = 256, window
        S, H, KVH, d, W = 2100, 16, 1, 256, 2048
        q = torch.randn(1, S, H, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(1, S, KVH, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(1, S, KVH, d, generator=gen, device=dev).to(dtype)
        out = fa_ops.flash_attention(q, k, v, causal=True, window=W)
        err = check_close(f"flash recurrentgemma-9b {dname}", out,
                          flash_attention_ref(q, k, v, causal=True,
                                              window=W), dname)
        keep = keep_mask(S, S, window=W, device=dev)
        b_ms, b_by = bound(*fa_ops.flash_attention_work(
            q, k, causal=True, window=W), dname)
        rows.append(dict(
            kernel="flash_attention", shape="recurrentgemma-9b", dtype=dname,
            S=S, T=S, H=H, KVH=KVH, d=d, window=W, prefix_pad=0,
            prefix_len=0, max_abs_err=err, tol=TOL[dname],
            launch_key=dict(fa_ops.launch_key(q, k, causal=True, window=W)),
            **flash_times(dict(causal=True, window=W), keep, (q, k, v)),
            bound_ms=b_ms, bound_by=b_by))

    # the RG-LRU scan is float32 only, as the reference kernel is: the
    # prefill's 2100 steps, a length inside one tile (37) and a single
    # step, and two batch rows (blocks slice the channels of one row)
    return rows + rglru_rows(gen, 4096, "recurrentgemma-9b", (
        (1, 2100, False), (1, 2100, True), (1, 37, True), (1, 1, False),
        (2, 2100, True)))


def rglru_rows(gen, Wd, shape, cases):
    """The RG-LRU scan against its plain version at width ``Wd``, for each
    (B, S, with an initial state) of ``cases``."""
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

    dev = "cuda"
    rows = []
    for B, S, with_h0 in cases:
        a = torch.sigmoid(torch.randn(B, S, Wd, generator=gen, device=dev))
        b = torch.randn(B, S, Wd, generator=gen, device=dev)
        h = torch.randn(B, Wd, generator=gen, device=dev) \
            if with_h0 else None
        out = lru_ops.rglru_scan(a, b, h)
        err = check_close(f"rglru_scan B={B} S={S} h0={with_h0}", out,
                          rglru_scan_ref(a, b, h), "float32")
        # one entry per read of a and b and per write of h; 2 flops each
        b_ms, b_by = bound(*lru_ops.rglru_scan_work(a, h), "float32")
        rows.append(dict(
            kernel="rglru_scan", shape=shape, dtype="float32",
            B=B, S=S, W=Wd, h0=with_h0, max_abs_err=err, tol=TOL["float32"],
            launch_key=dict(lru_ops.launch_key(a, h)),
            **kernel_times(lru_ops.rglru_scan, rglru_scan_ref, None,
                           (a, b, h)),
            library_note="no single PyTorch call computes a linear "
                         "recurrence with per-step coefficients",
            bound_ms=b_ms, bound_by=b_by))
    return rows


SSD_CASES = ((2048, False, "init"), (2048, True, "init"),
             (2100, False, "init"), (120, False, "init"), (2, False, "init"),
             (2048, False, "strong"))


def ssd_kernel_rows(gen, *, H=80, shape="mamba2-2.7b", cases=SSD_CASES):
    """The SSD chunk scan against its plain version at mamba2-2.7b's
    widths (H = 80 heads of P = 64, state N = 128, model chunk 256): the
    serving prefill's S = 2048 with and without an initial state, a ragged
    S = 2100, S = 120 (under one model chunk) and S = 2 (under one kernel
    chunk), and a strong decay whose in-chunk cumulative log decay falls
    below -100 (the output must stay finite).  Inputs are drawn as the
    model makes them: dt = softplus(N(0, 1)), a_log = 1 (the init) or 2
    for the strong decay."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    dev = "cuda"
    P, N, chunk = 64, 128, 256
    rows = []
    for S, with_h0, decay in cases:
        xh = torch.randn(1, S, H, P, generator=gen, device=dev)
        dt = F.softplus(torch.randn(1, S, H, generator=gen, device=dev))
        a_log = torch.full((H,), 1.0 if decay == "init" else 2.0,
                           device=dev)
        Bm = torch.randn(1, S, N, generator=gen, device=dev)
        Cm = torch.randn(1, S, N, generator=gen, device=dev)
        h0 = torch.randn(1, H, P, N, generator=gen, device=dev) \
            if with_h0 else None
        args = (xh, dt, a_log, Bm, Cm)
        kw = dict(chunk=chunk, initial_state=h0)
        y, hs = ssd_ops.ssd_chunked(*args, **kw)
        yr, hr = ssd_chunked_ref(*args, **kw)
        label = f"ssd S={S} h0={with_h0} decay={decay}"
        err = max(check_close(label + " y", y, yr, "float32", SSD_TOL),
                  check_close(label + " state", hs, hr, "float32", SSD_TOL))
        Q = ssd_ops.KERNEL_CHUNK
        da = (dt * -torch.exp(a_log))[0, :min(Q, S)]
        min_cum = da.cumsum(0).min().item()
        if decay == "strong" and not min_cum < -100:
            fail(f"{label}: the in-chunk log decay only reaches {min_cum}")
        # bytes: each input read once, y and the state written once;
        # operations: only those this run's decays leave nonzero
        flops = ssd_needed_flops((dt * -torch.exp(a_log))[0], with_h0, N, P)
        nbytes, _ = ssd_ops.ssd_chunked_work(xh, Bm, h0, flops)
        b_ms, b_by = bound(nbytes, flops, "float32")
        rows.append(dict(
            kernel="ssd_chunk_scan", shape=shape, dtype="float32",
            B=1, S=S, H=H, P=P, N=N, model_chunk=chunk, kernel_chunk=Q,
            h0=with_h0, decay=decay, min_in_chunk_cum=min_cum,
            max_abs_err=err, tol=SSD_TOL,
            launch_key=dict(ssd_ops.launch_key(xh, Bm, h0)),
            needed_flops=flops,
            bound_3xtf32_ms=max(nbytes / HBM_BYTES_PER_S,
                                flops / (TF32_FLOPS / 3)) * 1e3,
            **kernel_times(
                lambda *a: ssd_ops.ssd_chunked(*a[:5], chunk=chunk,
                                               initial_state=a[5]),
                lambda *a: ssd_chunked_ref(*a[:5], chunk=chunk,
                                           initial_state=a[5]),
                None, (*args, h0)),
            library_note="no single PyTorch call computes a chunked scan "
                         "with per-step decay",
            functions_ms=function_times(
                lambda *a: ssd_ops.ssd_chunked(*a[:5], chunk=chunk,
                                               initial_state=a[5]),
                (*args, h0), WRAPPER_FUNCS["ssd_chunk_scan"])
            if S == 2048 and decay == "init" and not with_h0 else None,
            bound_ms=b_ms, bound_by=b_by))
    return rows


def ssd_vs_float64(inputs, forms):
    """Each form's (y, final state) distance from the step recurrence
    h_t = exp(dt_t·A) h + dt_t x_t B_t, y_t = h_t C_t in float64 over the
    same inputs (x, dt, a_log, B, C), every batch row: the largest
    absolute error and the relative L2 error of y, and the state's
    largest absolute error."""
    xh, dt, a_log, Bm, Cm = inputs
    da = dt.double() * -torch.exp(a_log.double())
    xdt = xh.double() * dt.double()[..., None]
    Bd, Cd = Bm.double(), Cm.double()
    B, S, H, P = xh.shape
    h = torch.zeros(B, H, P, Bm.shape[-1], dtype=torch.float64,
                    device=xh.device)
    ys = []
    for t in range(S):
        h = torch.exp(da[:, t])[..., None, None] * h \
            + xdt[:, t, :, :, None] * Bd[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cd[:, t]))
    y64 = torch.stack(ys, 1)
    out = {}
    for name, (y, hs) in forms.items():
        y = y.double()
        out[name] = {"y_max_abs_err": (y - y64).abs().max().item(),
                     "y_rel_l2_err": ((y - y64).norm() / y64.norm()).item(),
                     "state_max_abs_err":
                         (hs.double() - h).abs().max().item()}
    return out


def ssd_needed_flops(da, with_h0, N, P):
    """The fewest float32 operations of the SSD scan at the log decays
    ``da`` [S, H] of one batch row: the fewer of the chunked form's
    (:func:`ssd_min_flops`, every product) and the quadratic form's over
    only the terms whose decay weight is not 0 in float32 (exp of a log
    decay under ``LOG_F32_UNDERFLOW``).  The quadratic form takes, for each
    step t and each s <= t with a nonzero weight exp(sum_{s<k<=t} da_k),
    C_t.B_s once for all heads (2N, over the pairs any head keeps) and its
    weighted xdt_s in each head that keeps the pair (2P); each step with a
    nonzero weight into the final state (2NP a head); and with an initial
    state, each step it still reaches (C_t.h0, 2NP a head) and its decay
    into the final state (2NP).  Counted in float64."""
    S, H = da.shape
    cum = da.double().cumsum(0)                       # [S, H]
    causal = torch.ones(S, S, dtype=torch.bool, device=da.device).tril()
    pairs = torch.zeros_like(causal)
    flops = 0
    for h in range(H):
        c = cum[:, h]
        keep = causal & (c[:, None] - c[None, :] > LOG_F32_UNDERFLOW)
        pairs |= keep
        n = int(keep.sum()) * 2 * P
        n += int((c[-1] - c > LOG_F32_UNDERFLOW).sum()) * 2 * N * P
        if with_h0:
            n += int((c > LOG_F32_UNDERFLOW).sum()) * 2 * N * P
            n += 2 * N * P if c[-1] > LOG_F32_UNDERFLOW else 0
        flops += n
    flops += int(pairs.sum()) * 2 * N
    return min(flops, ssd_min_flops(S, H, P, N, with_h0))


def ssd_min_flops(S, H, P, N, with_h0, max_chunk=256):
    """The fewest float32 operations of the chunked SSD scan over S steps,
    at whichever chunk length needs fewest: the multiply-adds of its
    products, the element-wise decays left out.  A chunk of n steps needs
    the causal half of C.B^T once for all heads, n(n+1)N; per head the
    masked intra-chunk product, n(n+1)P, and its state contribution,
    2nNP; and where a state comes in (every chunk but the first, unless
    an initial state is given) C.h_in, 2nNP, and the state's decay and
    sum, 2NP."""
    best = None
    for q in range(1, min(S, max_chunk) + 1):
        lens = [q] * (S // q) + ([S % q] if S % q else [])
        flops = 0
        for i, n in enumerate(lens):
            flops += n * (n + 1) * N + H * (n * (n + 1) * P + 2 * n * N * P)
            if i > 0 or with_h0:
                flops += H * (2 * n * N * P + 2 * N * P)
        best = flops if best is None else min(best, flops)
    return best


# whisper-medium's attention: 16 heads of 64 (MHA), 1500 encoder frames,
# a 448-position decoder cache, a batch of 8
WHISPER_ATTN = dict(B=8, H=16, KVH=16, d=64, T=1500, C=448)


def encdec_kernel_rows(gen):
    """whisper-medium's attention kernels against their plain versions:
    flash without a causal mask over the encoder (S = T = 1500, ragged
    in the last key tile) and over the prefill's cross-attention (the 4
    prompt rows over 1500 frames, under one 16-row tile), and causal over
    the prefill's decoder self-attention (S = T = 4), each with NaN past
    the inputs' last rows; contiguous decode attention over the decoder's
    self cache (C = 448, ragged positions) and over the encoder memory
    (C = 1500, every slot valid).  The library call is SDPA (with the
    causal mask as a boolean matrix)."""
    w = WHISPER_ATTN
    B, H, d, T = w["B"], w["H"], w["d"], w["T"]
    P = ENCDEC_PROMPT
    rows = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for case, S, Tk, causal in (("encoder", T, T, False),
                                    ("prefill cross", P, T, False),
                                    ("decoder self", P, P, True)):
            rows.append(flash_row(gen, "whisper-medium", case, dname, B=B,
                                  S=S, T=Tk, H=H, KVH=H, d=d, causal=causal))
        # the decode batch's self cache: ragged positions, one at the
        # capacity's end; the cross cache: every frame valid
        for case, C, pos in (
                ("decode self", w["C"], [447, 300, 129, 67, 64, 63, 4, 0]),
                ("decode cross", T, None)):
            rows.append(decode_kernel_row(
                gen, "decode_attention", "whisper-medium",
                dict(B=B, H=H, KVH=H, d=d, C=C, pos=pos), dname, dtype,
                case=case))
    return rows


# flash's forward at the train phases' shapes (bf16 activations): name →
# (case, B, S, T, H, KVH, d, causal, launches a train step at the phase's
# depth: twice a layer under remat)
TRAIN_FLASH = {
    "stablelm-3b": [("train", 4, 1024, 1024, 32, 32, 80, True, 32)],
    "olmoe-1b-7b": [("train", 4, 1024, 1024, 16, 16, 128, True, 4)],
    "whisper-medium": [
        ("train encoder", 4, 1500, 1500, 16, 16, 64, False, 48),
        ("train decoder self", 4, 448, 448, 16, 16, 64, True, 48),
        ("train cross", 4, 448, 1500, 16, 16, 64, False, 48)],
}


def train_flash_rows(gen):
    """Flash's forward against its plain version at the shapes the train
    phases give it, in bf16 (:func:`flash_row`)."""
    return [flash_row(gen, shape, case, "bfloat16", B=B, S=S, T=T, H=H,
                      KVH=KVH, d=d, causal=causal,
                      launches_per_train_step=per_step)
            for shape, cases in TRAIN_FLASH.items()
            for case, B, S, T, H, KVH, d, causal, per_step in cases]


def flash_row(gen, shape, case, dname, *, B, S, T, H, KVH, d, causal,
              **extra):
    """One flash row without a prefix: seeded q [B,S,H,d] and k, v
    [B,T,KVH,d] in ``dname``, the kernel against its plain version, NaN
    past the inputs' last rows giving a bit-equal output, its device
    time, bound and SDPA's time (a causal mask as a boolean matrix)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)
    dtype = getattr(torch, dname)
    q = torch.randn(B, S, H, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, KVH, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, KVH, d, generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal)
    label = f"flash {shape} {case} {dname}"
    out = fa_ops.flash_attention(q, k, v, **kw)
    err = check_close(label, out, flash_attention_ref(q, k, v, **kw), dname)
    check_flash_tail_nan(label, q, k, v, kw, out)
    keep = keep_mask(S, T, device="cuda") if causal else None
    b_ms, b_by = bound(*fa_ops.flash_attention_work(q, k, **kw), dname)
    return dict(kernel="flash_attention", shape=shape, case=case,
                dtype=dname, B=B, S=S, T=T, H=H, KVH=KVH, d=d,
                causal=causal, prefix_pad=0, prefix_len=0, max_abs_err=err,
                tol=TOL[dname], launch_key=dict(fa_ops.launch_key(q, k, **kw)),
                **extra, **flash_times(kw, keep, (q, k, v)), bound_ms=b_ms,
                bound_by=b_by)


def check_flash_tail_nan(label, q, k, v, kw, out):
    """The rows past the last query and key rows (the tails of the last
    tiles) are never read: with NaN in the memory just past each of q, k
    and v, the output is the same bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def tailed(t):
        buf = torch.full((t.shape[0] + 1, *t.shape[1:]), float("nan"),
                         dtype=t.dtype, device=t.device)
        buf[:-1] = t
        return buf[:-1]

    if not torch.equal(fa_ops.flash_attention(tailed(q), tailed(k),
                                              tailed(v), **kw), out):
        fail(f"{label}: NaN past the last rows changed the output")


# ---------------------------------------------------------------------------
# phase 3: serve full-width stablelm-3b


# the tensor-parallel shards' attention shapes in the kernels phase:
# stablelm-3b's (serve_tp) and olmoe-1b-7b's (serve_tp_families)
SHARD_SHAPES = {"stablelm-3b/tp2": dict(H=16, KVH=16, d=80),
                "stablelm-3b/tp4": dict(H=8, KVH=8, d=80),
                "olmoe-1b-7b/tp2": dict(H=8, KVH=8, d=128),
                "olmoe-1b-7b/tp4": dict(H=4, KVH=4, d=128)}
# the paged serve phases' engine and traffic: a 384-token shared prefix,
# then 8 concurrent requests with these suffix lengths and 32 new tokens
# each
SERVE_ENGINE = dict(max_slots=8, max_len=1024, page_size=16,
                    prefill_chunk=256, prefix_cache_budget=256 << 20,
                    device="cuda")
SERVE_PREFIX = 384
SERVE_SUFFIXES = (32, 41, 50, 59, 68, 77, 86, 96)


def phase_serve(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, **SERVE_ENGINE)
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                          size=SERVE_PREFIX)]
    suf_lens = SERVE_SUFFIXES
    prompts = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                     size=n)]
               for n in suf_lens]

    counters = launch_counters()
    outs, launches, shapes, serve_s = serve_counted(
        engine, prompts, 32, counters, warm=prefix)
    launches = {n: launches[n] for n in ("paged_decode_attention",
                                         "flash_attention")}

    st = engine.stats()
    L = cfg.num_layers
    graph = check_paged_serve("serve", cfg, st, outs, launches)

    # -- one prefill and one decode step, kernels vs plain versions
    prompt = prompts[-1]
    comparisons, inp = kernel_vs_plain(model, params, prompt)
    chunk_ms = prefill_chunk_ms(model, params, inp)

    # a second wave of requests over the warm prefix, under the profiler
    wave = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=n)]
            for n in suf_lens]
    first_wave = decode_stats(engine)
    profile = profile_wave(engine, wave, "serve_profile.txt")
    dec = sorted(engine.decode_step_s)
    traced = traced_wave(engine, prefix, [
        prefix + [int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
        for n in suf_lens])
    graph["vs_eager"] = graph_vs_eager("serve", engine, seed)
    del engine
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # bf16, information only: kernel and plain version round attention
    # outputs to bf16 at different points, and 32 random layers amplify
    # that rounding to ~2% of the logits, too close to any bf16 limit to
    # separate a kernel's error from it.  The same model in float32 is
    # the check: there the kernel path must match the plain one tightly.
    logits_bf16 = logits_agreement(comparisons, cfg.vocab_size, None,
                                   "bf16")
    del comparisons
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init(seed, device="cuda", dtype=torch.float32)
    logits_f32 = logits_agreement(
        kernel_vs_plain(model32, params32, prompt)[0], cfg.vocab_size,
        LOGITS_TOL_F32, "f32")
    del params32
    contiguous = contiguous_opt_out(model, params, prefix, prompts, outs,
                                    counters)

    emit({"phase": "serve", "model": cfg.name, "layers": L,
          "params": model.num_params(), "init_s": init_s,
          "serve_s": serve_s, "requests": len(prompts),
          "new_tokens": sum(len(o) for o in outs),
          "decode_steps": st["steps"],
          "decode_step_median_ms": statistics.median(dec) * 1e3,
          "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
          "decode_tokens_per_s": st["decode_tokens"] / max(sum(dec), 1e-9),
          "decode_s": first_wave["decode_s"],
          "first_step_ms": first_wave["first_step_ms"],
          "prefill_chunks": st["prefill_chunks"],
          "prefill_chunk_ms": chunk_ms,
          "prefill_tokens_computed": st["prefill_tokens_computed"],
          "prefill_tokens_reused": st["prefill_tokens_reused"],
          "kv_admit_copies": st["kv_admit_copies"],
          "paged": st["paged"], "launches": launches, "graph": graph,
          "logits_vs_plain": {"bfloat16": logits_bf16,
                              "float32": logits_f32},
          "profiled_wave": profile, "traced_wave": traced,
          "contiguous": contiguous, "peak_memory_gb": peak_gb})
    return launches, shapes


def prefill_chunk_ms(model, params, inp):
    """Milliseconds of a cold 256-token prefill chunk and of a 128-token
    suffix over a 512-padded prefix, host work included (``inp`` from
    :func:`kernel_vs_plain`)."""
    with torch.no_grad():
        return {
            "cold_256": call_ms(lambda: model.prefill(
                params, {"tokens": inp["tokens"][:, :256]}, capacity=256),
                warmup=1, reps=5),
            "prefix512_suffix128": call_ms(lambda: model.prefill(
                params, {"tokens": inp["suffix"]}, capacity=128,
                **inp["prefix_kw"]), warmup=1, reps=5),
        }


def check_paged_serve(label, cfg, st, outs, launches, shards=1):
    """A paged engine's first warm-prefix fan-out: 32 in-vocab tokens a
    request, the prefix reused, no KV copied at admission, one paged
    decode launch per layer per decode step and one flash launch per
    layer per prefill chunk (each per shard of a tensor-parallel engine),
    and the decode graph (:func:`check_graph`).  → the graph's stats."""
    L = cfg.num_layers * shards
    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"{label} request {i}: {len(o)} tokens, or a token outside "
                 f"the vocab")
    if st["prefill_tokens_reused"] <= 0:
        fail(f"{label}: the shared prefix was not reused")
    if st["kv_admit_copies"] != 0:
        fail(f"{label}: kv_admit_copies {st['kv_admit_copies']} != 0")
    if launches["paged_decode_attention"] != L * st["steps"]:
        fail(f"{label}: paged decode launched "
             f"{launches['paged_decode_attention']} times for "
             f"{st['steps']} decode steps of {L} layers")
    if launches["flash_attention"] != L * st["prefill_chunks"]:
        fail(f"{label}: flash launched {launches['flash_attention']} times "
             f"for {st['prefill_chunks']} prefill chunks of {L} layers")
    return check_graph(label, st["decode_graph"], st["steps"],
                       {"paged_decode_attention": L})


def contiguous_opt_out(model, params, prefix, prompts, paged_outs,
                       counters):
    """The dense model on the contiguous layout it may opt into
    (``kv_layout="contiguous"``, 4 slots of 1024 positions, a radix trie
    of KV segments): the same warm-prefix fan-out, with exact launches
    (contiguous decode attention per layer per step, flash per layer per
    prefill chunk, no paged decode), one KV splice per admission and the
    prefix reused.  Its tokens' agreement with the paged engine's is
    printed, not held: the two layouts run different decode kernels and
    round bf16 differently."""
    from repro_torch.serving.engine import ServingEngine

    L = model.cfg.num_layers
    engine = ServingEngine(model, params, max_slots=4, max_len=1024,
                           kv_layout="contiguous", prefill_chunk=256,
                           prefix_cache_budget=256 << 20, device="cuda")
    outs, launches, _, serve_s = serve_counted(engine, prompts, 32,
                                               counters, warm=prefix)
    st = engine.stats()
    check_launches("serve contiguous", launches, {
        "decode_attention": L * st["steps"],
        "flash_attention": L * st["prefill_chunks"]})
    if st["kv_admit_copies"] != len(prompts):
        fail(f"serve contiguous: {st['kv_admit_copies']} KV splices for "
             f"{len(prompts)} admissions")
    if st["prefill_tokens_reused"] <= 0:
        fail("serve contiguous: the shared prefix was not reused")
    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < model.cfg.vocab_size
                                   for t in o):
            fail(f"serve contiguous request {i}: {len(o)} tokens, or one "
                 f"outside the vocab")
    graph = check_graph("serve contiguous", st["decode_graph"], st["steps"],
                        {"decode_attention": L})
    dec = decode_stats(engine)
    graph["vs_eager"] = graph_vs_eager("serve contiguous", engine, 1)
    same = sum(a == b for o, p in zip(outs, paged_outs)
               for a, b in zip(o, p))
    return {"requests": len(prompts), "serve_s": serve_s, **dec,
            "prefill_chunks": st["prefill_chunks"],
            "prefill_tokens_reused": st["prefill_tokens_reused"],
            "kv_admit_copies": st["kv_admit_copies"],
            "prefix_cache": st["prefix_cache"], "launches": launches,
            "graph": graph,
            "tokens_equal_to_paged": same / sum(map(len, outs)),
            "requests_equal_to_paged": sum(
                o == p for o, p in zip(outs, paged_outs))}


def traced_wave(engine, prefix, prompts):
    """One more warm-prefix fan-out under ``repro_torch.obs.tracing()``:
    one ``decode.step`` span per decode step served; → span counts by
    name."""
    from collections import Counter

    from repro_torch import obs

    async def wave():
        await engine.warm_prefix(prefix)
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=32) for p in prompts])
        await engine.stop()
        return outs

    steps0 = engine.steps
    t0 = time.perf_counter()
    with obs.tracing() as trz:
        asyncio.run(wave())
    seconds = time.perf_counter() - t0
    counts = Counter(s.name for s in trz.spans + trz.instants)
    steps = engine.steps - steps0
    if counts["decode.step"] != steps:
        fail(f"traced wave: {counts['decode.step']} decode.step spans for "
             f"{steps} decode steps")
    return {"decode_steps": steps, "seconds": seconds,
            "spans": dict(sorted(counts.items())),
            "report": trace_report(trz, "serve_trace_report.txt")}


def trace_report(trz, table):
    """The port's critical-path report over a trace: wall time, the
    components on the critical path, idle, and achieved against ideal
    parallelism (the rendered report goes to ``OUT_DIR / table``).  The
    path's segments must sum to the wall time."""
    from repro_torch import obs

    rep = obs.report(trz)
    total = sum(seg.dur for seg in rep.path)
    if not rep.path or abs(total - rep.wall_s) > 1e-9 * max(1.0, rep.wall_s):
        fail(f"trace report: {len(rep.path)} segments summing to {total} s "
             f"over a wall time of {rep.wall_s} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / table).write_text(rep.render(top=16) + "\n")
    return {"wall_ms": rep.wall_s * 1e3, "spans": rep.n_spans,
            "segments": len(rep.path), "segments_ms": total * 1e3,
            "idle_ms": rep.idle_s * 1e3,
            "critical_path": [
                {"component": f"{c.cat}:{c.name}" if c.cat else c.name,
                 "ms": c.critical_s * 1e3, "segments": c.critical_segments,
                 "inclusive_ms": c.inclusive_s * 1e3, "spans": c.count}
                for c in rep.top_blockers(8)],
            "busy_ms": rep.busy_external_s * 1e3,
            "achieved_parallelism": rep.achieved_parallelism,
            "ideal_parallelism": rep.ideal_parallelism,
            "ideal_makespan_ms": rep.ideal_makespan_s * 1e3}


def check_graph(label, graph, steps, per_step):
    """The engine's decode graph after its first ``steps`` decode steps:
    captured once, right after the first step (which ran eagerly),
    replayed for every later step, each replay counting the launches of
    one eager step (``per_step``; kernels it omits or gives 0 launch
    nothing).  → the graph's stats."""
    want = {n: k for n, k in per_step.items() if k}
    if graph is None or graph["captures"] != 1 \
            or graph["replays"] != steps - 1 \
            or graph["launches_per_replay"] != want:
        fail(f"{label}: decode graph {graph} after {steps} steps; want one "
             f"capture, {steps - 1} replays of {want} launches each")
    return dict(graph)


def graph_vs_eager(label, engine, seed):
    """One replay of the engine's captured decode step on its own state
    against one eager step of the same inputs on a clone of that state:
    the logits and every cache, pool and input tensor must be bit-equal
    (the same kernels at the same shapes).  The inputs put every slot at
    a random token and position, each slot on pages of its own."""
    from repro_torch.serving.decode_graph import tensors

    gen = np.random.RandomState(seed)
    S = engine.max_slots
    engine._cur_tokens[:, 0] = gen.randint(0, engine.cfg.vocab_size, S)
    engine._positions[:] = gen.randint(1, engine.max_len - 1, S)
    if engine.paged_kv:
        pps = engine.pages_per_slot
        engine._page_table[:] = 1 + np.arange(S * pps).reshape(S, pps) \
            % engine.num_pages
        engine._table_dirty = True
    engine._upload_step_inputs()
    state = engine._step_state()
    clone = clone_tree(state)
    with torch.no_grad():
        if engine.paged_kv:
            eager, _ = engine.model.decode_step_paged(engine.params, *clone)
        else:
            eager, _ = engine.model.decode_step(engine.params, *clone,
                                                capacity=engine.max_len)
    replay = engine._graph.replay()
    torch.cuda.synchronize()
    return hold_bit_equal(label, [("logits", replay, eager)] + [
        (f"state{i}", a, b)
        for i, (a, b) in enumerate(zip(tensors(state), tensors(clone)))])


def hold_bit_equal(label, pairs):
    """Each (name, a, b) must agree exactly (NaN where both hold NaN);
    → the largest difference and the count of tensors held."""
    worst = 0.0
    for name, a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{label} {name}: {a.dtype}{tuple(a.shape)} against "
                 f"{b.dtype}{tuple(b.shape)}")
        if a.is_floating_point() and not torch.equal(a.isnan(), b.isnan()):
            fail(f"{label} {name}: NaN in different places")
        d = 0.0 if torch.equal(a, b) or not a.numel() else \
            (a.double() - b.double()).nan_to_num(0.0).abs().max().item()
        if d != 0:
            fail(f"{label} {name}: graph replay differs from the eager step "
                 f"by up to {d}")
        worst = max(worst, d)
    return {"max_abs_diff": worst, "tensors": len(pairs)}


def plain_kernels():
    """Patch the model to call every kernel's plain version: attention
    (flash, paged decode, contiguous decode dense and int8), the RG-LRU
    scan and the SSD chunk scan."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_int8_ref, decode_attention_ref)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.multiple(
        "repro_torch.models.attention",
        fa_ops=mock.Mock(flash_attention=flash_attention_ref),
        pa_ops=mock.Mock(paged_decode_attention=paged_decode_attention_ref),
        da_ops=mock.Mock(decode_attention=decode_attention_ref,
                         decode_attention_int8=decode_attention_int8_ref)))
    stack.enter_context(mock.patch(
        "repro_torch.models.rglru.lru_ops",
        mock.Mock(rglru_scan=rglru_scan_ref)))
    stack.enter_context(mock.patch(
        "repro_torch.models.ssd.ssd_ops",
        mock.Mock(ssd_chunked=ssd_chunked_ref)))
    return stack


# ---------------------------------------------------------------------------
# phases 4 and 5: serve full-width recurrentgemma-9b and mamba2-2.7b
# (contiguous engine)

# prompt lengths of the hybrid wave: past the 2048 window (the prefill
# rolls the ring; decode wraps it again), inside it, and shorter than the
# conv history (2 < conv_width - 1 = 3)
HYBRID_PROMPTS = (2100, 2030, 1500, 700, 300, 120, 40, 2)
HYBRID_INT8_PROMPTS = (2100, 700, 40, 2)
# prompt lengths of the SSM wave: a multiple of the 256-step chunk, ragged
# tails, one exact chunk, under one chunk, at (3) and below (2) the conv
# history of conv_width - 1 = 3 steps
SSM_PROMPTS = (2048, 2100, 1500, 700, 256, 120, 3, 2)
# both waves: the prompt whose prefill and next decode step are held
# against the plain path, engine length and new tokens per request
COMPARE_PROMPT, MAX_LEN, MAX_NEW = 2100, 2304, 32


def serve_counted(engine, prompts, max_new, counters, warm=None):
    """Serve ``prompts`` concurrently (after warming the prefix ``warm``,
    if given) with every launch counter set to 0 just before; →
    (outputs, {name: launches}, {name: launches by key}, seconds)."""
    async def go():
        if warm is not None:
            await engine.warm_prefix(warm)
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=max_new) for p in prompts])
        await engine.stop()
        return outs

    zero_launches(counters)
    t0 = time.perf_counter()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (outs, *read_launches(counters), seconds)


def zero_launches(counters):
    """Every launch count to 0, in all and by launch key, and every
    backward count."""
    for fn in counters.values():
        fn.launches = 0
        fn.shapes.clear()
        fn.backwards = 0


def read_launches(counters):
    """→ ({name: launches}, {name: Counter of launches by the wrapper's
    launch key} over the kernels launched at all)."""
    return ({n: fn.launches for n, fn in counters.items()},
            {n: collections.Counter(fn.shapes)
             for n, fn in counters.items() if fn.shapes})


def add_shapes(a, b):
    """The sum of two {name: Counter by launch key} tables."""
    none = collections.Counter()
    return {n: a.get(n, none) + b.get(n, none) for n in set(a) | set(b)}


def shape_table(shapes):
    """{name: [{key fields, "launches"}, ...]} of a launch table, for
    printing; most launched first."""
    return {n: [{**dict(key), "launches": k}
                for key, k in shapes[n].most_common()]
            for n in sorted(shapes)}


def check_launches(label, launches, want):
    """``launches`` must equal ``want``, every kernel it omits at 0."""
    want = {**dict.fromkeys(launches, 0), **want}
    if launches != want:
        fail(f"{label}: launches {launches} != {want}")


def check_contiguous_serve(label, st, outs, n_requests, vocab):
    """The contiguous engine's stats and outputs after serving
    ``n_requests`` concurrent greedy requests: one exact-length admission
    and one slot copy each, MAX_NEW in-vocab tokens each."""
    if (st["kv_layout"], st["paged"], st["prefill_shape_bound"]) \
            != ("contiguous", False, None):
        fail(f"{label} engine stats {st}")
    if st["kv_admit_copies"] != n_requests \
            or st["prefill_chunks"] != n_requests:
        fail(f"{label}: {st['prefill_chunks']} admissions, "
             f"{st['kv_admit_copies']} slot copies for {n_requests} requests")
    for i, o in enumerate(outs):
        if len(o) != MAX_NEW or not all(0 <= t < vocab for t in o):
            fail(f"{label} request {i}: {len(o)} tokens, or one outside "
                 f"the vocab")


def decode_stats(engine):
    """The engine's decode steps so far: median and p90 ms, their sum
    (``decode_s``) and the first step's ms (eager, before the capture)."""
    dec = sorted(engine.decode_step_s)
    return {"decode_steps": engine.steps,
            "decode_step_median_ms": statistics.median(dec) * 1e3,
            "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
            "decode_tokens_per_s": engine.stats()["decode_tokens"]
            / max(sum(dec), 1e-9),
            "decode_s": sum(dec),
            "first_step_ms": engine.decode_step_s[0] * 1e3}


def serve_contiguous_phase(phase, cfg, seed, prompt_lens, want_launches,
                           vs_plain, prefill_lens, extra=None):
    """Full-width ``cfg`` in bf16 (seeded random weights on the card)
    behind the contiguous engine, 8 slots of MAX_LEN: 8 concurrent greedy
    requests of ``prompt_lens`` tokens and MAX_NEW new tokens each, with
    exact launch counts (``want_launches(steps, admissions)``, every other
    kernel 0); ``extra(model, params, prompts, counters)`` may serve more
    on the same weights and returns (fields to print, launches in all and
    by launch key).  Then
    the prefill time at ``prefill_lens``, a profiled second wave, the
    COMPARE_PROMPT prefill's and next decode step's logits through the
    kernels against the plain versions (``vs_plain(model, params, prompt,
    max_len)``): bf16 printed, the whole model in float32 held to
    LOGITS_TOL_F32; and the 2-token prompt's decode step against the
    full forward.  Prints the phase's line; → launches over every
    engine's counted wave, in all and by launch key."""
    import gc

    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.serving.engine import ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    counters = launch_counters()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in prompt_lens]

    engine = ServingEngine(model, params, max_slots=8, max_len=MAX_LEN,
                           device="cuda")
    outs, launches, shapes, serve_s = serve_counted(engine, prompts,
                                                    MAX_NEW, counters)
    st = engine.stats()
    check_launches(phase, launches,
                   want_launches(st["steps"], st["prefill_chunks"]))
    check_contiguous_serve(phase, st, outs, len(prompts), cfg.vocab_size)
    graph = check_graph(phase, st["decode_graph"], st["steps"],
                        want_launches(1, 0))
    dec = decode_stats(engine)
    more, total = {}, dict(launches)
    if extra is not None:
        more, launches2, shapes2 = extra(model, params, prompts, counters)
        total = {n: total[n] + launches2[n] for n in total}
        shapes = add_shapes(shapes, shapes2)

    with torch.no_grad():
        toks = {n: torch.tensor([prompts[prompt_lens.index(n)]],
                                dtype=torch.int32, device="cuda")
                for n in prefill_lens}
        prefill_ms = {f"{n}_tokens": call_ms(lambda n=n: model.prefill(
            params, {"tokens": toks[n]}, capacity=MAX_LEN), warmup=1, reps=3)
            for n in toks}
    profile = profile_wave(engine, prompts, f"{phase}_profile.txt")
    graph["vs_eager"] = graph_vs_eager(phase, engine, seed)
    del engine
    prompt = prompts[prompt_lens.index(COMPARE_PROMPT)]
    logits_bf16 = logits_agreement(vs_plain(model, params, prompt, MAX_LEN),
                                   cfg.vocab_size, None, "bf16")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    peak_bf16_gb = torch.cuda.max_memory_allocated() / 1e9

    # -- the whole model in float32: kernel path vs plain path, held
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = m32.init(seed, device="cuda", dtype=torch.float32)
    logits_f32 = logits_agreement(vs_plain(m32, params32, prompt, MAX_LEN),
                                  cfg.vocab_size, LOGITS_TOL_F32, "f32")
    short = short_prompt_vs_forward(m32, params32, prompts[-1], MAX_LEN)
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": phase, "model": cfg.name, "layers": cfg.num_layers,
          "params": model.num_params(), "init_s": init_s,
          "serve_s": serve_s, "requests": len(prompts),
          "prompt_tokens": list(prompt_lens),
          "new_tokens": sum(len(o) for o in outs), **dec,
          "prefill_ms": prefill_ms, "admissions": st["prefill_chunks"],
          "kv_admit_copies": st["kv_admit_copies"], "launches": launches,
          "graph": graph, **more,
          "logits_vs_plain": {"bfloat16": logits_bf16,
                              "float32": logits_f32},
          "short_prompt_decode_vs_forward_f32": short,
          "profiled_wave": profile, "peak_memory_gb_bf16": peak_bf16_gb,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return total, shapes


def phase_serve_hybrid(seed):
    from repro_torch.configs import get_config
    return serve_contiguous_phase(
        "serve_hybrid", get_config("recurrentgemma-9b"), seed,
        HYBRID_PROMPTS, lambda steps, adm: hybrid_launches(steps, adm,
                                                           int8=False),
        hybrid_kernel_vs_plain, (2100, 300), extra=hybrid_int8_wave)


def hybrid_launches(steps, admissions, *, int8):
    """The hybrid's exact launch counts: one decode-attention launch per
    attention block per decode step (the int8 kernel on an int8 cache,
    the dense one otherwise, never both), one flash and one RG-LRU scan
    launch per attention / recurrent block per admission."""
    return {"decode_attention_int8" if int8 else "decode_attention":
            12 * steps, "flash_attention": 12 * admissions,
            "rglru_scan": 26 * admissions}


def hybrid_int8_wave(model, params, prompts, counters):
    """An int8-KV engine on the same weights serving 4 of the wave's
    requests, then the same 4 again under the profiler; → (its line's
    fields, the counted wave's launches in all and by launch key)."""
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    model8 = build_model(dataclasses.replace(model.cfg,
                                             kv_cache_dtype="int8"))
    prompts8 = [prompts[HYBRID_PROMPTS.index(n)] for n in HYBRID_INT8_PROMPTS]
    engine8 = ServingEngine(model8, params, max_slots=8, max_len=MAX_LEN,
                            device="cuda")
    outs8, launches8, shapes8, serve8_s = serve_counted(
        engine8, prompts8, MAX_NEW, counters)
    st8 = engine8.stats()
    check_launches("serve_hybrid int8 KV", launches8,
                   hybrid_launches(st8["steps"], st8["prefill_chunks"],
                                   int8=True))
    check_contiguous_serve("serve_hybrid int8 KV", st8, outs8, len(prompts8),
                           model.cfg.vocab_size)
    graph8 = check_graph("serve_hybrid int8 KV", st8["decode_graph"],
                         st8["steps"], hybrid_launches(1, 0, int8=True))
    dec8 = decode_stats(engine8)
    profile8 = profile_wave(engine8, prompts8, "serve_hybrid_int8_profile.txt")
    graph8["vs_eager"] = graph_vs_eager("serve_hybrid int8 KV", engine8, 1)
    return {"int8": {"requests": len(prompts8), "serve_s": serve8_s,
                     "decode_steps": dec8["decode_steps"],
                     "decode_step_median_ms": dec8["decode_step_median_ms"],
                     "decode_step_p90_ms": dec8["decode_step_p90_ms"],
                     "launches": launches8, "graph": graph8,
                     "profiled_wave": profile8}}, launches8, shapes8


def hybrid_kernel_vs_plain(model, params, prompt, max_len):
    """Last logits of a full-prompt prefill (longer than the window: the
    ring rolls) and of one decode step past the wrap, through the kernels
    and through the plain versions, for the dense KV cache (``model``) and
    the int8 one (same parameters).  Both decode steps start from a copy
    of the kernel path's prefill cache.
    → {name: (kernel logits, plain logits)}."""
    from repro_torch.models import build_model

    model8 = build_model(dataclasses.replace(model.cfg,
                                             kv_cache_dtype="int8"))
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    out = {}
    with torch.no_grad():
        for tag, m in (("", model), ("_int8", model8)):
            lg_k, cache = m.prefill(params, {"tokens": toks},
                                    capacity=max_len)
            with plain_kernels():
                lg_p, _ = m.prefill(params, {"tokens": toks},
                                    capacity=max_len)
            out["prefill" + tag] = (lg_k, lg_p)
            cur = lg_k.argmax(-1).to(torch.int32)[:, None]
            copy = clone_tree(cache)
            lg_k2, _ = m.decode_step(params, cache, cur, pos)
            with plain_kernels():
                lg_p2, _ = m.decode_step(params, copy, cur, pos)
            out["decode_step" + tag] = (lg_k2, lg_p2)
            del cache, copy
    return out


def clone_tree(tree):
    """A copy of every tensor of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone()


def short_prompt_vs_forward(model, params, prompt, max_len):
    """A prompt shorter than the conv history: prefill it, take one decode
    step with the greedy token, and hold that step's logits against the
    full forward's at the same position (relative L2, float32)."""
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": toks}, capacity=max_len)
        cur = lg.argmax(-1).to(torch.int32)[:, None]
        pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
        step, _ = model.decode_step(params, cache, cur, pos)
        full, _ = model.forward(params, {"tokens": torch.cat([toks, cur], 1)})
    vocab = model.cfg.vocab_size
    a, b = step.float()[:, :vocab], full[:, -1].float()[:, :vocab]
    rel = ((a - b).norm() / b.norm()).item()
    if not rel <= LOGITS_TOL_F32:
        fail(f"{len(prompt)}-token prompt: decode after prefill vs forward "
             f"rel L2 error {rel} > {LOGITS_TOL_F32}")
    return {"prompt_tokens": len(prompt), "rel_l2_err": rel,
            "tol": LOGITS_TOL_F32}


def phase_serve_ssm(seed):
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-2.7b")
    # one chunk-scan launch per SSD block per admission; decode runs none
    return serve_contiguous_phase(
        "serve_ssm", cfg, seed, SSM_PROMPTS,
        lambda steps, adm: {"ssd_chunk_scan": cfg.num_layers * adm},
        ssm_kernel_vs_plain, (2048, 256))


def ssm_kernel_vs_plain(model, params, prompt, max_len):
    """Last logits of a full-prompt prefill through the kernels and through
    the plain versions, and of one decode step from each path's cache with
    the same token: the decode step has no kernel, so it compares the final
    SSM states the two prefills left.  → {name: (kernel, plain)}."""
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    pos = torch.tensor([len(prompt)], dtype=torch.int32, device="cuda")
    with torch.no_grad():
        lg_k, cache_k = model.prefill(params, {"tokens": toks},
                                      capacity=max_len)
        with plain_kernels():
            lg_p, cache_p = model.prefill(params, {"tokens": toks},
                                          capacity=max_len)
        cur = lg_k.argmax(-1).to(torch.int32)[:, None]
        lg_k2, _ = model.decode_step(params, cache_k, cur, pos)
        lg_p2, _ = model.decode_step(params, cache_p, cur, pos)
    return {"prefill": (lg_k, lg_p), "decode_step": (lg_k2, lg_p2)}


def kernel_vs_plain(model, params, prompt, plen=384, pad=512, ps=16):
    """Last logits of a full-prompt prefill, of a suffix prefill over the
    prompt's first ``plen`` tokens padded to ``pad``, and of one paged
    decode step, each through the kernels and through the plain versions.
    → ({name: (kernel logits, plain logits)}, the prefill inputs)."""
    L = model.cfg.num_layers
    n = len(prompt)
    toks = torch.tensor([prompt], dtype=torch.int32, device="cuda")
    out = {}
    with torch.no_grad():
        # full prompt, no prefix (flash's exact causal branch)
        lg_k, cache = model.prefill(params, {"tokens": toks}, capacity=n)
        with plain_kernels():
            lg_p, _ = model.prefill(params, {"tokens": toks}, capacity=n)
        out["prefill_full"] = (lg_k, lg_p)
        # suffix over the padded prefix (the engine's branch)
        pfx = {nm: torch.nn.functional.pad(
            t[:, :, :plen], (0, 0, 0, 0, 0, pad - plen))
            for nm, t in cache.items()}
        sb = 128
        sfx = torch.zeros(1, sb, dtype=torch.int32, device="cuda")
        sfx[0, :n - plen] = toks[0, plen:]
        kw = dict(prefix=pfx, prefix_len=plen, last_index=n - plen - 1)
        lg_k2, _ = model.prefill(params, {"tokens": sfx}, capacity=sb, **kw)
        with plain_kernels():
            lg_p2, _ = model.prefill(params, {"tokens": sfx}, capacity=sb,
                                     **kw)
        out["prefill_prefix"] = (lg_k2, lg_p2)
        # one decode step over a paged pool holding the prompt's KV
        npg = -(-(n + 1) // ps)
        pool = model.init_paged_cache(npg + 1, ps, device="cuda")
        ids = torch.arange(1, npg + 1, device="cuda")
        for nm in ("k", "v"):
            seg = torch.nn.functional.pad(
                cache[nm][:, 0], (0, 0, 0, 0, 0, npg * ps - n))
            pool[nm][:, ids] = seg.reshape(L, npg, ps, *seg.shape[2:])
        table = ids[None].to(torch.int32)
        pos = torch.tensor([n], dtype=torch.int32, device="cuda")
        cur = lg_k.argmax(-1).to(torch.int32)[:, None]
        pool2 = {nm: t.clone() for nm, t in pool.items()}
        lg_k3, _ = model.decode_step_paged(params, pool, cur, pos, table)
        with plain_kernels():
            lg_p3, _ = model.decode_step_paged(params, pool2, cur, pos,
                                               table)
        out["decode_step"] = (lg_k3, lg_p3)
    return out, {"tokens": toks, "suffix": sfx, "prefix_kw": kw}


def logits_agreement(comparisons, vocab, tol, label):
    """Relative L2 error, max abs error and argmax agreement of each
    (kernel, plain) pair over the real vocab; raises on non-finite
    logits, and above ``tol`` unless it is None."""
    report = {}
    for name, (a, b) in comparisons.items():
        a, b = a.float()[:, :vocab], b.float()[:, :vocab]  # pads are -1e30
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"{label} {name}: non-finite logits")
        rel = ((a - b).norm() / b.norm()).item()
        report[name] = {"rel_l2_err": rel, "tol": tol,
                        "max_abs_err": (a - b).abs().max().item(),
                        "argmax_agree": bool((a.argmax(-1)
                                              == b.argmax(-1)).all())}
        if tol is not None and rel > tol:
            fail(f"{label} {name}: kernel path vs plain path rel L2 error "
                 f"{rel} > {tol}")
    return report


def profile_wave(engine, prompts, table):
    """Serve ``prompts`` under ``torch.profiler``: the device's busy share
    of the wall time and device time by kernel (the full table goes to
    ``OUT_DIR / table``), beside the kernel wrappers' launch counts
    in the wave (the decode steps replay a CUDA graph: the profiler must
    see its kernels for the busy share to hold them).  None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.decode_graph import launch_counters

    async def wave():
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=32) for p in prompts])
        await engine.stop()
        return outs

    steps0, chunks0 = engine.steps, engine.prefill_chunks
    counters = launch_counters()
    launches0 = {n: c.launches for n, c in counters.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(wave())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report = profile_report(prof, wall_us, table)
    if report is None:
        return None
    return {**report, "decode_steps": engine.steps - steps0,
            "prefill_chunks": engine.prefill_chunks - chunks0,
            "wrapper_launches": {n: c.launches - launches0[n]
                                 for n, c in counters.items()
                                 if c.launches != launches0[n]}}


def profile_report(prof, wall_us, table):
    """A profile's device time over a window of ``wall_us``: the busy
    share, the top kernels and the port's kernels by device time (the
    full table goes to ``OUT_DIR / table``); None where the profiler saw
    no device time."""
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / table).write_text("".join(
        f"{dev:14.1f} us {cnt:8d}x  {key}\n" for dev, cnt, key in rows))
    if busy <= 0:
        return None
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "top_kernels": [{"name": key[:80], "ms": dev / 1e3,
                             "share_of_busy": dev / busy, "count": cnt}
                            for dev, cnt, key in rows[:8]],
            "port_kernels": [{"name": key[:120], "ms": dev / 1e3,
                              "share_of_busy": dev / busy, "count": cnt,
                              "per_call_ms": dev / 1e3 / cnt}
                             for dev, cnt, key in rows
                             if any(f in key for f in PORT_KERNEL_FUNCS)],
            "wrappers": wrapper_times(rows)}


def wrapper_times(rows):
    """Device ms a call of each wrapper that launches several CUDA
    functions: the sum over its functions, over its calls (the count of
    the function launched most)."""
    out = {}
    for name, funcs in WRAPPER_FUNCS.items():
        hits = by_function(rows, funcs)
        if hits:
            calls = max(n for _, n in hits.values())
            out[name] = {"calls": calls, "per_call_ms": sum(
                d for d, _ in hits.values()) / 1e3 / calls}
    return out


# ---------------------------------------------------------------------------
# phase 6: serve full-width olmoe-1b-7b (paged engine, MoE)

def phase_serve_moe(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, moe
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("olmoe-1b-7b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, **SERVE_ENGINE)
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                          size=SERVE_PREFIX)]

    def wave():
        return [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                      size=n)]
                for n in SERVE_SUFFIXES]
    prompts = wave()
    counters = launch_counters()
    outs, launches, shapes, serve_s = serve_counted(
        engine, prompts, 32, counters, warm=prefix)
    launches = {n: launches[n] for n in ("paged_decode_attention",
                                         "flash_attention")}
    st = engine.stats()
    graph = check_paged_serve("serve_moe", cfg, st, outs, launches)
    first_wave = decode_stats(engine)

    # one prefill and one decode step, kernels vs plain versions (bf16,
    # printed only), with each layer's routing on both paths
    bf16 = moe_vs_plain(model, params, prompts[-1], None, "bf16")
    inp = bf16.pop("inputs")
    chunk_ms = prefill_chunk_ms(model, params, inp)
    # the assignments the capacity bound drops in one 256-token chunk
    log = []
    with torch.no_grad(), record_routing(log):
        model.prefill(params, {"tokens": inp["tokens"][:, :256]},
                      capacity=256)
    K = cfg.num_experts_per_tok
    chunk_drops = {"tokens": 256, "capacity": moe.expert_capacity(cfg, 256),
                   "assignments_per_layer": 256 * K,
                   "dropped_per_layer": [r["dropped"] for r in log],
                   "max_load_per_layer": [r["max_load"] for r in log],
                   "dropped": sum(r["dropped"] for r in log)}

    profile = profile_wave(engine, wave(), "serve_moe_profile.txt")
    dec = sorted(engine.decode_step_s)
    graph["vs_eager"] = graph_vs_eager("serve_moe", engine, seed)
    del engine, params
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same model in float32 (27.7 GB): the kernel path must match the
    # plain one at positions before any routing near-tie tips
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init(seed, device="cuda", dtype=torch.float32)
    f32 = moe_vs_plain(model32, params32, prompts[-1], LOGITS_TOL_F32,
                       "f32")
    f32.pop("inputs")
    del params32
    # every weight but the embedding table, read once a decode step
    weight_bytes = 2 * (model.num_params() - cfg.vocab_padded * cfg.d_model)

    emit({"phase": "serve_moe", "model": cfg.name,
          "layers": cfg.num_layers, "experts": cfg.num_experts,
          "top_k": K, "capacity_factor": cfg.moe_capacity_factor,
          "params": model.num_params(), "init_s": init_s,
          "serve_s": serve_s, "requests": len(prompts),
          "new_tokens": sum(len(o) for o in outs),
          "decode_steps": st["steps"],
          "decode_step_median_ms": statistics.median(dec) * 1e3,
          "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
          "decode_step_byte_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_tokens_per_s": st["decode_tokens"] / max(sum(dec), 1e-9),
          "decode_s": first_wave["decode_s"],
          "first_step_ms": first_wave["first_step_ms"],
          "prefill_chunks": st["prefill_chunks"],
          "prefill_chunk_ms": chunk_ms,
          "prefill_tokens_computed": st["prefill_tokens_computed"],
          "prefill_tokens_reused": st["prefill_tokens_reused"],
          "kv_admit_copies": st["kv_admit_copies"],
          "paged": st["paged"], "launches": launches, "graph": graph,
          "chunk_drops": chunk_drops,
          "vs_plain": {"bfloat16": bf16, "float32": f32},
          "profiled_wave": profile, "peak_memory_gb": peak_gb})
    return launches, shapes


def record_routing(log):
    """Patch the MoE layer to append, for each call, the experts each
    token chose (as a sorted set), the gap between each token's K-th and
    (K+1)-th router probability, the assignments the capacity bound
    dropped and the most any expert was sent.  → the patch, a context
    manager."""
    from unittest import mock

    from repro_torch.models import moe
    apply = moe.apply_moe

    def recorded(cfg, p, x):
        K = cfg.num_experts_per_tok
        with torch.no_grad():
            probs, _, idx = moe.route(cfg, p, x.reshape(-1, x.shape[-1]))
            top = probs.topk(K + 1, dim=-1).values
            keep = moe.queue_positions(idx, cfg.num_experts) \
                < moe.expert_capacity(cfg, idx.shape[0])
        log.append({"experts": idx.sort(-1).values,
                    "gap": top[:, K - 1] - top[:, K],
                    "dropped": int((~keep).sum()),
                    "max_load": int(torch.bincount(
                        idx.reshape(-1), minlength=cfg.num_experts).max())})
        return apply(cfg, p, x)
    return mock.patch.object(moe, "apply_moe", recorded)


def routing_diffs(kern, plain):
    """The tokens whose expert set differs between two runs' routing logs
    (:func:`record_routing`, one entry per layer): (position, layer, the
    plain run's K-th − (K+1)-th probability gap there), by position."""
    diffs = []
    for layer, (a, b) in enumerate(zip(kern, plain)):
        rows = (a["experts"] != b["experts"]).any(-1).nonzero()[:, 0]
        diffs += [(int(j), layer, float(b["gap"][j])) for j in rows]
    return sorted(diffs)


# the cases of moe_vs_plain, in the order they call the model (each
# through the kernels, then through the plain versions)
MOE_CASES = ("prefill_full", "prefill_prefix", "decode_step", "forward")


def moe_vs_plain(model, params, prompt, tol, label, plen=384):
    """:func:`kernel_vs_plain` for an MoE model plus the full forward's
    logits at every position, with each layer's routing recorded on both
    paths.  Where the paths' last-bit differences tip a router near-tie,
    a token's top-k set differs: its output changes by a whole expert,
    and so do the later tokens (through attention and the capacity
    queue).  So the logits are held (``tol``; None prints only) at the
    positions before the first token whose set differs in any layer: the
    forward's rows before it, and a last-position case only if its
    position comes before it.  → a report per case: the agreement, the
    positions held, and the differing (layer, position, K-th − (K+1)-th
    probability gap), the first 8; plus ``inputs`` for the caller."""
    L = model.cfg.num_layers
    n = len(prompt)
    log = []
    with record_routing(log):
        comparisons, inp = kernel_vs_plain(model, params, prompt, plen=plen)
        with torch.no_grad():
            lf_k, _ = model.forward(params, {"tokens": inp["tokens"]})
            with plain_kernels():
                lf_p, _ = model.forward(params, {"tokens": inp["tokens"]})
    comparisons["forward"] = (lf_k[0], lf_p[0])
    if len(log) != 2 * len(MOE_CASES) * L:
        fail(f"{label}: {len(log)} MoE calls recorded, want "
             f"{2 * len(MOE_CASES) * L}")
    last = {"prefill_full": n - 1, "prefill_prefix": n - plen - 1,
            "decode_step": 0}
    report = {}
    for c, name in enumerate(MOE_CASES):
        diffs = routing_diffs(log[2 * c * L:(2 * c + 1) * L],
                              log[(2 * c + 1) * L:(2 * c + 2) * L])
        first = diffs[0][0] if diffs else None
        a, b = comparisons[name]
        if name == "forward":
            held = n if first is None else first
            if held == 0:
                fail(f"{label} forward: routing differs at position 0")
            a, b = a[:held], b[:held]
        else:
            held = int(first is None or last[name] < first)
        agree = logits_agreement({name: (a, b)}, model.cfg.vocab_size,
                                 tol, label)[name] if held else None
        report[name] = {"logits": agree, "positions_held": held,
                        "routing_diffs": len(diffs),
                        "first_diffs": [
                            {"position": j, "layer": layer, "gap": gap}
                            for j, layer, gap in diffs[:8]]}
    report["inputs"] = inp
    return report


# ---------------------------------------------------------------------------
# phase 7: encoder-decoder whisper-medium at the model level

# Whisper's decoder: the 4-token start-of-transcript sequence (start,
# language, task, no-timestamps) and its 448-position context; a batch
# of 8 requests, each 1500 encoder frames (30 s of audio)
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_CAPACITY, ENCDEC_STEPS = 8, 4, 448, 64


def encdec_inputs(cfg, seed, dtype):
    """Seeded frame embeddings [B, enc_seq, D] (the stubbed conv front
    end's output) in ``dtype`` and decoder prompts [B, 4]."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    frames = torch.randn(ENCDEC_BATCH, cfg.enc_seq, cfg.d_model,
                         generator=gen, device="cuda").to(dtype)
    rng = np.random.RandomState(seed)
    tokens = torch.tensor(rng.randint(0, cfg.vocab_size,
                                      size=(ENCDEC_BATCH, ENCDEC_PROMPT)),
                          dtype=torch.int32, device="cuda")
    return {"tokens": tokens, "encoder_frames": frames}


def encdec_greedy(model, params, batch, steps):
    """``Model.prefill`` at ENCDEC_CAPACITY, then ``steps`` greedy
    ``Model.decode_step`` s, each timed on the host clock to a
    synchronize.  → (tokens [B, steps + 1], step seconds, the cache and
    the next position)."""
    V = model.cfg.vocab_size
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, ENCDEC_CAPACITY)
        toks = [logits[:, :V].argmax(-1).to(torch.int32)]
        pos = torch.full((ENCDEC_BATCH,), ENCDEC_PROMPT, dtype=torch.int32,
                         device="cuda")
        step_s = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, toks[-1][:, None],
                                              pos, capacity=ENCDEC_CAPACITY)
            toks.append(logits[:, :V].argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            pos = pos + 1
    return torch.stack(toks, 1), step_s, cache, pos


def encdec_vs_plain(model, params, batch, steps, tol, label):
    """The prefill's and ``steps`` decode steps' logits through the
    kernels against the plain versions, both paths fed the kernel path's
    greedy tokens; with ``tol`` (relative L2) every step is held and the
    plain path's greedy token must equal the kernel path's at every step;
    with None both are printed only."""
    V = model.cfg.vocab_size
    comps, same = {}, []
    with torch.no_grad():
        lk, ck = model.prefill(params, batch, ENCDEC_CAPACITY)
        with plain_kernels():
            lp, cp = model.prefill(params, batch, ENCDEC_CAPACITY)
        comps["prefill"] = (lk, lp)
        pos = torch.full((ENCDEC_BATCH,), ENCDEC_PROMPT, dtype=torch.int32,
                         device="cuda")
        for i in range(steps + 1):
            tok = lk[:, :V].argmax(-1)
            same.append(bool(torch.equal(tok, lp[:, :V].argmax(-1))))
            if tol is not None and not same[-1]:
                fail(f"{label}: greedy tokens differ after "
                     f"{'the prefill' if i == 0 else f'decode step {i}'}")
            if i == steps:
                break
            cur = tok.to(torch.int32)[:, None]
            lk, _ = model.decode_step(params, ck, cur, pos)
            with plain_kernels():
                lp, _ = model.decode_step(params, cp, cur, pos)
            comps[f"decode_{i}"] = (lk, lp)
            pos = pos + 1
    report = logits_agreement(comps, V, tol, label)
    dec = [report[f"decode_{i}"] for i in range(steps)]
    worst = max(dec, key=lambda r: r["rel_l2_err"])
    return {"prefill": report["prefill"], "decode_steps": steps,
            "decode_worst": {**worst, "step": dec.index(worst)},
            "decode_rel_l2_err_median": statistics.median(
                r["rel_l2_err"] for r in dec),
            "greedy_tokens_equal_steps": sum(same),
            "greedy_compared": len(same)}


def encdec_step_floor(cfg, batch, steps):
    """The bytes a decode step must move, averaged over the ``steps``
    steps after a ENCDEC_PROMPT-token prefill: the decoder's weights that
    a step reads (everything but the cross-attention's K/V projections,
    whose output is the cached memory), the tied head (the whole
    embedding table), the cross K/V memory and the valid self K/V rows,
    in bf16."""
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    qd, kvd = cfg.q_dim, cfg.kv_dim
    per_layer = (2 * D * qd + 2 * D * kvd      # self: wq, wo, wk, wv
                 + 2 * D * qd                  # cross: wq, wo
                 + 2 * D * F + F + D           # the GELU MLP and biases
                 + 3 * 2 * D)                  # three layernorms
    weights = 2 * (L * per_layer + 2 * D)
    head = 2 * cfg.vocab_padded * D
    cross = 2 * 2 * L * batch * cfg.enc_seq * kvd
    mean_rows = ENCDEC_PROMPT + (steps + 1) / 2
    self_kv = 2 * 2 * L * batch * mean_rows * kvd
    total = weights + head + cross + self_kv
    return {"decoder_weights_gb": weights / 1e9, "tied_head_gb": head / 1e9,
            "cross_kv_gb": cross / 1e9, "self_kv_gb": self_kv / 1e9,
            "total_gb": total / 1e9,
            "floor_ms": total / HBM_BYTES_PER_S * 1e3}


def phase_encdec(seed):
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec
    from repro_torch.serving.decode_graph import launch_counters

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-medium")
    model = build_model(cfg)
    L, E = cfg.num_layers, cfg.enc_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = encdec_inputs(cfg, seed, torch.bfloat16)

    # the main path: prefill, then greedy decode steps, counted
    counters = launch_counters()
    zero_launches(counters)
    toks, step_s, cache, pos = encdec_greedy(model, params, batch,
                                             ENCDEC_STEPS)
    launches, shapes = read_launches(counters)
    # flash: each encoder layer, and each decoder layer's self- and
    # cross-attention in the prefill; decode attention: each decoder
    # layer's self- and cross-attention in each step
    check_launches("encdec", launches, {
        "flash_attention": E + 2 * L,
        "decode_attention": 2 * L * ENCDEC_STEPS})
    if toks.shape != (ENCDEC_BATCH, ENCDEC_STEPS + 1) \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        fail(f"encdec: tokens {tuple(toks.shape)} or outside the vocab")

    with torch.no_grad():
        encode_ms = call_ms(lambda: encdec.encode(cfg, params,
                                                  batch["encoder_frames"]),
                            warmup=1, reps=5)
        prefill_ms = call_ms(lambda: model.prefill(params, batch,
                                                   ENCDEC_CAPACITY),
                             warmup=1, reps=5)
        profile = profile_steps(
            lambda: model.decode_step(params, cache, toks[:, -1:], pos), 4,
            "encdec_profile.txt")
    del cache
    dec = sorted(step_s)
    median_ms = statistics.median(dec) * 1e3
    floor = encdec_step_floor(cfg, ENCDEC_BATCH, ENCDEC_STEPS)
    bf16 = encdec_vs_plain(model, params, batch, ENCDEC_STEPS, None, "bf16")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    peak_bf16_gb = torch.cuda.max_memory_allocated() / 1e9

    # the same path in float32 at full depth: held
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = model32.init(seed, device="cuda", dtype=torch.float32)
    f32 = encdec_vs_plain(model32, params32,
                          encdec_inputs(cfg, seed, torch.float32),
                          ENCDEC_STEPS, LOGITS_TOL_F32, "encdec f32")
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    busy_ms = profile["device_busy_ms"] / profile["steps"] \
        if profile else None
    emit({"phase": "encdec", "model": cfg.name, "enc_layers": E,
          "dec_layers": L, "enc_seq": cfg.enc_seq,
          "params": model.num_params(), "init_s": init_s,
          "batch": ENCDEC_BATCH, "prompt_tokens": ENCDEC_PROMPT,
          "capacity": ENCDEC_CAPACITY, "decode_steps": ENCDEC_STEPS,
          "encode_ms": encode_ms, "prefill_ms": prefill_ms,
          "decode_step_median_ms": median_ms,
          "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
          "first_step_ms": step_s[0] * 1e3,
          "decode_tokens_per_s": ENCDEC_BATCH * ENCDEC_STEPS / sum(step_s),
          "decode_step_byte_floor": floor,
          "decode_step_device_busy_ms": busy_ms,
          "host_bound": busy_ms is not None and busy_ms < 0.5 * median_ms,
          "eager": "the steps run eagerly (the decode graph is the "
                   "engine's, which does not admit encoder-decoder "
                   "requests)",
          "launches": launches, "launches_by_shape": shape_table(shapes),
          "profiled_steps": profile,
          "vs_plain": {"bfloat16": bf16, "float32": f32},
          "peak_memory_gb_bf16": peak_bf16_gb,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, shapes


def profile_steps(fn, n, table):
    """``n`` calls of ``fn`` under ``torch.profiler``:
    :func:`profile_report` over them, with ``steps``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report = profile_report(prof, wall_us, table)
    return None if report is None else {"steps": n, **report}


# ---------------------------------------------------------------------------
# phase 8: serve full-width pixtral-12b (paged engine, VLM)

# the float32 check's depth: pixtral-12b's 12.77 B parameters are 51 GB
# in float32; 8 of its 40 layers at full width are 14.5 GB
VLM_F32_LAYERS = 8
# image patches ahead of the text in the patch-embedding prefill
VLM_PATCHES = 256


def patch_batch(cfg, tokens, seed, dtype):
    """``{"tokens", "patch_embeds"}``: VLM_PATCHES seeded patch embeddings
    [1, n, D] at the embedding table's scale (0.02), in ``dtype``, to
    replace the prompt's first n token embeddings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    pe = 0.02 * torch.randn(1, VLM_PATCHES, cfg.d_model, generator=gen,
                            device="cuda")
    return {"tokens": tokens, "patch_embeds": pe.to(dtype)}


def patch_prefill_vs_plain(model, params, batch):
    """The last logits of a prefill with patch embeddings, through the
    kernels and through the plain versions."""
    n = batch["tokens"].shape[1]
    with torch.no_grad():
        lk, _ = model.prefill(params, batch, capacity=n)
        with plain_kernels():
            lp, _ = model.prefill(params, batch, capacity=n)
    return lk, lp


def phase_serve_vlm(seed):
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.serving.engine import ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("pixtral-12b")
    model = build_model(cfg)
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, **SERVE_ENGINE)
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                          size=SERVE_PREFIX)]

    def wave():
        return [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                      size=n)]
                for n in SERVE_SUFFIXES]
    prompts = wave()
    counters = launch_counters()
    outs, launches, shapes, serve_s = serve_counted(
        engine, prompts, 32, counters, warm=prefix)
    st = engine.stats()
    check_launches("serve_vlm", launches, {
        "paged_decode_attention": L * st["steps"],
        "flash_attention": L * st["prefill_chunks"]})
    graph = check_paged_serve("serve_vlm", cfg, st, outs, launches)
    first_wave = decode_stats(engine)

    comparisons, inp = kernel_vs_plain(model, params, prompts[-1])
    logits_bf16 = logits_agreement(comparisons, cfg.vocab_size, None, "bf16")
    del comparisons
    chunk_ms = prefill_chunk_ms(model, params, inp)
    # one prefill with image patches ahead of the prompt: L flash launches
    pbatch = patch_batch(cfg, inp["tokens"], seed, torch.bfloat16)
    n = inp["tokens"].shape[1]
    with torch.no_grad():
        zero_launches(counters)
        patch_logits, _ = model.prefill(params, pbatch, capacity=n)
        check_launches("serve_vlm patch prefill", read_launches(counters)[0],
                       {"flash_attention": L})
        if not bool(torch.isfinite(patch_logits[:, :cfg.vocab_size]).all()):
            fail("serve_vlm: non-finite logits after the patch prefill")
        patch_ms = call_ms(lambda: model.prefill(params, pbatch, capacity=n),
                           warmup=1, reps=3)

    profile = profile_wave(engine, wave(), "serve_vlm_profile.txt")
    dec = sorted(engine.decode_step_s)
    graph["vs_eager"] = graph_vs_eager("serve_vlm", engine, seed)
    del engine, params, pbatch, patch_logits
    gc.collect()
    torch.cuda.empty_cache()
    peak_bf16_gb = torch.cuda.max_memory_allocated() / 1e9

    # float32 at full width and VLM_F32_LAYERS layers: held
    cfg32 = dataclasses.replace(cfg, num_layers=VLM_F32_LAYERS,
                                dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(seed, device="cuda", dtype=torch.float32)
    comps32, inp32 = kernel_vs_plain(model32, params32, prompts[-1])
    comps32["patch_prefill"] = patch_prefill_vs_plain(
        model32, params32, patch_batch(cfg, inp32["tokens"], seed,
                                       torch.float32))
    logits_f32 = logits_agreement(comps32, cfg.vocab_size, LOGITS_TOL_F32,
                                  "serve_vlm f32")
    del params32, comps32
    gc.collect()
    torch.cuda.empty_cache()
    # every weight but the embedding table, read once a decode step
    weight_bytes = 2 * (model.num_params() - cfg.vocab_padded * cfg.d_model)

    emit({"phase": "serve_vlm", "model": cfg.name, "layers": L,
          "params": model.num_params(), "init_s": init_s,
          "serve_s": serve_s, "requests": len(prompts),
          "new_tokens": sum(len(o) for o in outs),
          "decode_steps": st["steps"],
          "decode_step_median_ms": statistics.median(dec) * 1e3,
          "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
          "decode_step_byte_floor_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_tokens_per_s": st["decode_tokens"] / max(sum(dec), 1e-9),
          "decode_s": first_wave["decode_s"],
          "first_step_ms": first_wave["first_step_ms"],
          "prefill_chunks": st["prefill_chunks"],
          "prefill_chunk_ms": chunk_ms,
          "patch_prefill": {"patches": VLM_PATCHES, "tokens": n,
                            "ms": patch_ms},
          "prefill_tokens_computed": st["prefill_tokens_computed"],
          "prefill_tokens_reused": st["prefill_tokens_reused"],
          "kv_admit_copies": st["kv_admit_copies"],
          "paged": st["paged"], "launches": launches,
          "launches_by_shape": shape_table(shapes), "graph": graph,
          "logits_vs_plain": {
              "bfloat16": logits_bf16,
              "float32": {"layers": VLM_F32_LAYERS,
                          "note": "full width, 8 of 40 layers: the whole "
                                  "model is 51 GB in float32",
                          **logits_f32}},
          "profiled_wave": profile, "peak_memory_gb_bf16": peak_bf16_gb,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, shapes


# ---------------------------------------------------------------------------
# the kernels phase's backward rows: each autograd Function at the train
# phases' shapes


# the train phases' shapes of each trained kernel
BACKWARD_SHAPES = {
    "flash_attention": {
        "stablelm-3b": dict(B=4, S=1024, H=32, KVH=32, d=80, window=0),
        "recurrentgemma-9b": dict(B=1, S=2304, H=16, KVH=1, d=256,
                                  window=2048)},
    "rglru_scan": dict(B=1, S=2304, W=4096),
    "ssd_chunk_scan": dict(B=4, S=1024, H=80, P=64, N=128, chunk=256)}


def backward_kernel_rows(gen):
    """Each trained kernel wrapper's ``torch.autograd.Function`` on the
    card at the train phases' shapes: its forward (the kernel;
    ``forward_max_abs_err``) and its backward (``max_abs_err``), each held
    against the plain version and autograd through it (bf16 2e-2, f32
    2e-5, SSD 2e-4).  Flash's and SSD's backwards recompute through the
    plain version, as their reference does, so their backward error only
    shows the Function's wiring (both sides run the same recompute); the
    kernel is held by the forward's error.  Flash at stablelm-3b's (B 4, S = T =
    1024, 32 heads of 80, causal) and recurrentgemma-9b's (B 1, S = T =
    2304, 16 heads over 1 of 256, window 2048) in bf16 and f32; the RG-LRU
    scan at recurrentgemma-9b's (B 1, S 2304, W 4096) and the SSD scan at
    mamba2-2.7b's (B 4, S 1024, 80 heads of 64, N 128, chunk 256), f32.
    Times: the backward alone (``ms``: flash's and SSD's recompute through
    the plain version, RG-LRU's reversed scan in the kernel), autograd's
    forward and backward through the plain version (``plain_ms``), and
    flash's yardstick, the backward of one SDPA call (``library_ms``).
    Bound: the backward's inputs (the forward's inputs and the output's
    cotangent) read once and its gradients written once, or its fewest
    operations (flash: the recomputed scores and the four products of the
    backward, 10·pairs·H·d; SSD: three times the forward's needed
    operations, the recompute and two products for each of its
    products; RG-LRU: the scan's multiply-add and da's product, 3 an
    element)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    dev = "cuda"
    rows = []

    def grads(fn, inputs, cot):
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*xs), xs, cot)

    def forward_and_grads(fn, inputs, cot):
        """(the outputs, detached, as a tuple; the inputs' gradients)."""
        xs = [t.detach().requires_grad_() for t in inputs]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        return (tuple(o.detach() for o in outs),
                torch.autograd.grad(outs, xs, cot))

    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        es = torch.finfo(dtype).bits // 8
        for sname, sh in BACKWARD_SHAPES["flash_attention"].items():
            B, S, H, KVH, d, W = (sh[k] for k in ("B", "S", "H", "KVH", "d",
                                                  "window"))
            q = torch.randn(B, S, H, d, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, KVH, d, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(B, S, KVH, d, generator=gen,
                            device=dev).to(dtype)
            g = torch.randn(B, S, H, d, generator=gen, device=dev).to(dtype)
            kw = dict(causal=True, window=W)
            (out,), got = forward_and_grads(
                lambda q, k, v: fa_ops.flash_attention(q, k, v, **kw),
                (q, k, v), g)
            (out_ref,), want = forward_and_grads(
                lambda q, k, v: flash_attention_ref(q, k, v, **kw),
                (q, k, v), g)
            label = f"flash backward {sname} {dname}"
            fwd_err = check_close(f"{label} forward", out, out_ref, dname)
            err = max(check_close(f"{label} {n}", a, b, dname)
                      for n, a, b in zip("qkv", got, want))
            del out, out_ref
            keep = keep_mask(S, S, window=W, device=dev)
            pairs = int(keep.sum().item()) * B
            b_ms, b_by = bound((3 * q.numel() + 4 * k.numel()) * es,
                               10 * pairs * H * d, dname)
            qs, ks, vs = (t.detach().transpose(1, 2).requires_grad_()
                          for t in (q, k, v))
            with torch.enable_grad():
                lib_out = sdpa(qs, ks, vs, keep)
            gt = g.transpose(1, 2)
            rows.append(dict(
                kernel="flash_attention_backward", shape=sname, dtype=dname,
                B=B, S=S, T=S, H=H, KVH=KVH, d=d, window=W,
                forward_max_abs_err=fwd_err, max_abs_err=err, tol=TOL[dname],
                **kernel_times(
                    lambda q, k, v, g: fa_ops.flash_attention_vjp(
                        q, k, v, g, **kw),
                    lambda q, k, v, g: grads(
                        lambda *x: flash_attention_ref(*x, **kw),
                        (q, k, v), g),
                    lambda q, k, v, g: torch.autograd.grad(
                        lib_out, (qs, ks, vs), gt, retain_graph=True),
                    (q, k, v, g)),
                library_note="the backward of one SDPA call (its forward "
                             "run once, outside the timing)",
                bound_ms=b_ms, bound_by=b_by))
            del lib_out, qs, ks, vs

    # RG-LRU: the backward is the kernel's scan over reversed time
    B, S, Wd = (BACKWARD_SHAPES["rglru_scan"][k] for k in ("B", "S", "W"))
    a = torch.sigmoid(torch.randn(B, S, Wd, generator=gen, device=dev))
    b = torch.randn(B, S, Wd, generator=gen, device=dev)
    g = torch.randn(B, S, Wd, generator=gen, device=dev)
    (h,), got = forward_and_grads(lru_ops.rglru_scan, (a, b), g)
    (h_ref,), want = forward_and_grads(rglru_scan_ref, (a, b), g)
    fwd_err = check_close("rglru backward forward", h, h_ref, "float32")
    err = max(check_close(f"rglru backward {n}", x, y, "float32")
              for n, x, y in zip(("da", "db"), got, want))
    del h_ref
    b_ms, b_by = bound(5 * a.numel() * 4, 3 * a.numel(), "float32")
    rows.append(dict(
        kernel="rglru_scan_backward", shape="recurrentgemma-9b",
        dtype="float32", B=B, S=S, W=Wd, forward_max_abs_err=fwd_err,
        max_abs_err=err, tol=TOL["float32"],
        **kernel_times(lru_ops.rglru_scan_vjp,
                       lambda a, h, g: grads(rglru_scan_ref, (a, b), g),
                       None, (a, h, g)),
        library_note="no single PyTorch call computes a linear "
                     "recurrence with per-step coefficients",
        bound_ms=b_ms, bound_by=b_by))

    # SSD: the backward recomputes through the plain version's chunked form
    B, S, H, P, N, chunk = (BACKWARD_SHAPES["ssd_chunk_scan"][k]
                            for k in ("B", "S", "H", "P", "N", "chunk"))
    xh = torch.randn(B, S, H, P, generator=gen, device=dev)
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    a_log = torch.ones(H, device=dev)
    Bm = torch.randn(B, S, N, generator=gen, device=dev)
    Cm = torch.randn(B, S, N, generator=gen, device=dev)
    gy = torch.randn(B, S, H, P, generator=gen, device=dev)
    gh = torch.zeros(B, H, P, N, device=dev)
    inputs = (xh, dt, a_log, Bm, Cm)
    outs, got = forward_and_grads(
        lambda *x: ssd_ops.ssd_chunked(*x, chunk=chunk), inputs, (gy, gh))
    outs_ref, want = forward_and_grads(
        lambda *x: ssd_chunked_ref(*x, chunk=chunk), inputs, (gy, gh))
    fwd_err = max(check_close(f"ssd backward forward {n}", x, y, "float32",
                              SSD_TOL)
                  for n, x, y in zip(("y", "state"), outs, outs_ref))
    vs_f64 = ssd_vs_float64(inputs, {"kernel": outs, "plain": outs_ref})
    del outs, outs_ref
    err = max(check_close(f"ssd backward d{n}", x, y, "float32", SSD_TOL)
              for n, x, y in zip(("xh", "dt", "a_log", "B", "C"), got, want))
    da = dt * -torch.exp(a_log)
    flops = 3 * sum(ssd_needed_flops(da[i], False, N, P) for i in range(B))
    nbytes = 4 * (3 * xh.numel() + 2 * (dt.numel() + H + Bm.numel()
                                         + Cm.numel()) + gh.numel())
    b_ms, b_by = bound(nbytes, flops, "float32")
    rows.append(dict(
        kernel="ssd_chunk_scan_backward", shape="mamba2-2.7b",
        dtype="float32", B=B, S=S, H=H, P=P, N=N, model_chunk=chunk,
        forward_max_abs_err=fwd_err, forward_vs_float64=vs_f64,
        max_abs_err=err, tol=SSD_TOL,
        **kernel_times(
            lambda *x: ssd_ops.ssd_chunked_vjp(x[:5], x[5:], chunk=chunk),
            lambda *x: grads(lambda *y: ssd_chunked_ref(*y, chunk=chunk),
                             x[:5], x[5:]),
            None, (*inputs, gy, gh)),
        library_note="no single PyTorch call computes a chunked scan "
                     "with per-step decay",
        bound_ms=b_ms, bound_by=b_by))
    return rows


# ---------------------------------------------------------------------------
# phases 9-11: train full-width stablelm-3b, mamba2-2.7b and
# recurrentgemma-9b

TRAIN_LR = 1e-4
# the MoE gradient check's batches: it holds the first whose routing agrees
# between the kernel path and the plain path in every call
MOE_CHECK_BATCHES = 4
# the main path's steps (the first warms up and is not timed) on one
# batch, repeated
TRAIN_STEPS = 6
# stablelm-3b and mamba2-2.7b at half depth: at full depth each train
# state's checkpoint round trip (33.5 GB) took 50-56 s of host disk time,
# and the whole script came within 30 s of its 1200 s limit
TRAIN_CASES = {
    "train": dict(arch="stablelm-3b", batch=4, seq=1024, layers=16,
                  check_layers=2,
                  why="half depth at full width: the whole script's time "
                      "limit (the checkpoint round trip of the full train "
                      "state)"),
    "train_ssm": dict(arch="mamba2-2.7b", batch=4, seq=1024, layers=32,
                      check_layers=2,
                      why="half depth at full width: the whole script's "
                          "time limit (the checkpoint round trip of the "
                          "full train state)"),
    # one (rglru, rglru, attn) group at full width: 38 blocks need ~167 GB
    # of train state; S = 2304 runs past the 2048 window
    "train_hybrid": dict(arch="recurrentgemma-9b", batch=1, seq=2304,
                         layers=3, check_layers=3,
                         why="one rglru/rglru/attn group at full width: the "
                             "train state of all 38 blocks (~167 GB) would "
                             "not fit one card"),
    # two of olmoe-1b-7b's 16 layers at full width (1.05 B parameters):
    # the train state of all 16 needs ~111 GB
    "train_moe": dict(arch="olmoe-1b-7b", batch=4, seq=1024, layers=2,
                      check_layers=2,
                      why="two MoE layers at full width: the train state of "
                          "all 16 (~111 GB) would not fit one card"),
    # whisper-medium whole: 24 + 24 layers, 4 × 1500 frames and decoder
    # sequences of 448 tokens (the context the encdec phase serves)
    "train_encdec": dict(arch="whisper-medium", batch=4, seq=448,
                         check_layers=2),
}
# the profiler ranges of a profiled train step: the forward and loss
# (``train:forward``) and the optimizer (``train:optimizer``), which
# ``make_train_step`` opens, and each Function's backward
# (``train:backward:<wrapper>``)
TRAIN_RANGE = "train:"
# the train state's checkpoint, written and read back, then removed
TRAIN_CKPT_DIR = ROOT / ".chip_ckpt"


def train_counts(cfg):
    """({kernel: launches}, {kernel: backward calls}) of one train step,
    from the model's layer groups: under remat each group's forward runs
    again in the backward (the tail blocks run once), and the RG-LRU
    scan's backward is one more launch of its kernel; flash's and SSD's
    backwards recompute through the plain version.  The encoder-decoder
    calls flash once an encoder layer (non-causal self-attention) and
    twice a decoder layer (causal self-attention and the cross-attention
    over the encoder's output), each layer under remat."""
    from repro_torch.models import lm
    if cfg.family == "enc_dec":
        calls = cfg.enc_layers + 2 * cfg.num_layers
        runs = 1 if cfg.remat == "none" else 2
        return {"flash_attention": runs * calls}, {"flash_attention": calls}
    group, n_groups, tail = lm._layer_groups(cfg)
    runs = collections.Counter()
    for kind in group:
        runs[kind] += n_groups * (1 if cfg.remat == "none" else 2)
    for kind in tail:
        runs[kind] += 1
    calls = collections.Counter()
    for kind in group * n_groups + tail:
        calls[{"rglru_mlp": "rglru_scan", "ssd": "ssd_chunk_scan"}.get(
            kind, "flash_attention")] += 1
    launches = {"flash_attention": sum(
        n for k, n in runs.items() if k.startswith("attn")),
        "rglru_scan": runs["rglru_mlp"] + calls["rglru_scan"],
        "ssd_chunk_scan": runs["ssd"]}
    return ({k: n for k, n in launches.items() if n},
            {k: n for k, n in calls.items() if n})


def range_device_ms(prof, prefix):
    """{range: device ms of the kernels launched inside it} of the
    profiler's ``record_function`` ranges named ``prefix...``; None where
    the profiler gives a range no device time."""
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(prefix):
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = getattr(e, "cuda_time_total", 0)
            out[e.key] = {"ms": dev / 1e3 if dev else None,
                          "calls": e.count}
    return out


def grads_vs_plain(model, params, batch, tol, label):
    """The kernel path's loss and every parameter gradient against the
    same model under :func:`plain_kernels` (relative L2 per leaf); held
    at ``tol`` when given, else printed only."""
    from repro_torch.launch import steps
    loss_k, _, gk = steps.loss_and_grads(model, params, batch)
    with plain_kernels():
        loss_p, _, gp = steps.loss_and_grads(model, params, batch)
    return hold_grads(loss_k, gk, loss_p, gp, tol, label)


def moe_grads_vs_plain(model, params, batches, tol, label):
    """:func:`grads_vs_plain` for an MoE model with each layer's routing
    recorded on both paths (:func:`record_routing`).  Where last-bit
    differences tip a router near-tie, a token's top-k set differs and
    the gradients differ by whole experts, for a reason that is not the
    kernel: that batch is reported (the differing calls, positions and
    probability gaps, the first 8) and the next one tried; the gradients
    are held on the first batch of ``batches`` whose sets agree in every
    call.  With no ``tol`` (printed only) the first batch is reported
    whatever its routing, with the count of tokens whose sets differ."""
    from repro_torch.launch import steps
    skipped = []
    for i, batch in enumerate(batches):
        log = []
        with record_routing(log):
            loss_k, _, gk = steps.loss_and_grads(model, params, batch)
            n = len(log)
            with plain_kernels():
                loss_p, _, gp = steps.loss_and_grads(model, params, batch)
        if len(log) != 2 * n:
            fail(f"{label}: {n} MoE calls on the kernel path, "
                 f"{len(log) - n} on the plain path")
        diffs = routing_diffs(log[:n], log[n:])
        if diffs and tol is not None:
            skipped.append({"batch": i, "tokens_differing": len(diffs),
                            "first_diffs": [
                                {"position": j, "call": c, "gap": gap}
                                for j, c, gap in diffs[:8]]})
            del gk, gp
            continue
        return {**hold_grads(loss_k, gk, loss_p, gp, tol, label),
                "batch": i, "moe_calls": n, "routing_diffs": len(diffs),
                "batches_with_routing_diffs": skipped}
    fail(f"{label}: the routing differs between the paths on every one of "
         f"{len(batches)} batches: {skipped}")


def hold_grads(loss_k, gk, loss_p, gp, tol, label):
    """Relative errors of the kernel path's loss and gradients against the
    plain path's, held at ``tol`` (None: printed only)."""
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    errs = {k: rel_l2(gk[k], gp[k]) for k in gk}
    worst = max(errs, key=errs.get)
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    if tol is not None and not (finite and loss_err <= tol
                                and errs[worst] <= tol):
        fail(f"{label}: kernel path against plain: loss {loss_err}, "
             f"worst gradient {worst} {errs[worst]} (tol {tol}, "
             f"finite {finite})")
    return {"loss_rel_err": loss_err, "worst_leaf": worst,
            "worst_grad_rel_l2": errs[worst], "leaves": len(errs),
            "tol": tol}


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_train(phase, seed):
    import gc
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.tree import flatten

    case = TRAIN_CASES[phase]
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(case["arch"])
    cfg = full.replace(remat="full", microbatches=1,
                       num_layers=case.get("layers", full.num_layers))
    reduced = [] if cfg.num_layers == full.num_layers else [
        f"num_layers {full.num_layers} -> {cfg.num_layers} "
        f"({case['why']})"]
    model = build_model(cfg)
    optimizer = AdamW(learning_rate=TRAIN_LR)
    B, S = case["batch"], case["seq"]
    host_batch = train_batch(cfg, B, S, 0, seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = steps.init_train_state(model, optimizer, seed, device="cuda")
    batch = train_device_batch(cfg, host_batch)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = steps.make_train_step(model, optimizer)
    want, want_vjp = train_counts(cfg)

    # the main path: TRAIN_STEPS steps on the same batch, counted.  Each
    # forward launches its kernel or takes the plain version (CPU tensors
    # only), so launches equal to the forwards the layers make also say
    # that no plain forward ran on the card
    counters = launch_counters()
    losses, step_s = [], []
    zero_launches(counters)
    for i in range(TRAIN_STEPS):
        before = {n: (c.launches, c.backwards) for n, c in counters.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t0)
        check_launches(f"{phase} step {i}", {
            n: c.launches - before[n][0] for n, c in counters.items()}, want)
        backwards = {n: c.backwards - before[n][1]
                     for n, c in counters.items()
                     if c.backwards != before[n][1]}
        if backwards != want_vjp:
            fail(f"{phase} step {i}: backward calls {backwards} != "
                 f"{want_vjp}")
    launches, shapes = read_launches(counters)
    # one more step, profiled: make_train_step names its parts as ranges
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    profiled = profile_report(prof, wall_us, f"{phase}_profile.txt")
    if profiled is not None:
        profiled["ranges"] = range_device_ms(prof, TRAIN_RANGE)
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        fail(f"{phase}: losses {losses} (all finite, the last below the "
             f"first)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = sorted(step_s[1:])
    median_s = statistics.median(timed)
    tokens = B * S
    n_params = model.num_params()
    flops = train_model_flops(model, B, S)

    # the state after the last step: a checkpoint written and read back
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    path = ckpt.save(TRAIN_CKPT_DIR, int(state["step"]), state)
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    t0 = time.perf_counter()
    back, back_step = ckpt.restore(TRAIN_CKPT_DIR, state, device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_CKPT_DIR)
    a, b = flatten(state), flatten(back)
    for k in a:
        if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k]):
            fail(f"{phase}: checkpoint leaf {k} did not read back "
                 f"bit-equal")
    if back_step != int(state["step"]):
        fail(f"{phase}: checkpoint step {back_step}")
    del state, back, a, b, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()

    # the f32 gradient check at full width and check_layers layers: the
    # kernel path against the plain path; bf16 printed only
    check = {}
    for dname, tol in (("float32", LOGITS_TOL_F32), ("bfloat16", None)):
        depth = {"num_layers": case["check_layers"]}
        if cfg.family == "enc_dec":
            depth["enc_layers"] = case["check_layers"]
        ccfg = cfg.replace(dtype=dname, **depth)
        cm = build_model(ccfg)
        params = cm.init(seed, device="cuda")
        label = f"{phase} {dname} gradients"
        if cfg.family == "moe":
            check[dname] = moe_grads_vs_plain(
                cm, params, [train_device_batch(ccfg, train_batch(
                    ccfg, B, S, i, seed)) for i in range(MOE_CHECK_BATCHES)],
                tol, label)
        else:
            check[dname] = grads_vs_plain(
                cm, params, train_device_batch(ccfg, host_batch), tol, label)
        del params
        gc.collect()
        torch.cuda.empty_cache()

    emit({"phase": phase, "card": card(), "model": cfg.name,
          "layers": cfg.num_layers, "reduced": reduced, "params": n_params,
          "remat": cfg.remat, "dtype": cfg.dtype,
          "param_dtype": cfg.param_dtype, "lr": TRAIN_LR,
          "batch": B, "seq": S, "tokens_per_step": tokens,
          "init_s": init_s, "losses": losses,
          "first_step_s": step_s[0], "step_median_s": median_s,
          "step_p90_s": timed[int(0.9 * (len(timed) - 1))],
          "tokens_per_s": tokens / median_s,
          "model_flops_per_step": flops,
          "mfu": flops / median_s / PEAK_FLOPS["bfloat16"],
          "launches_per_step": want, "backward_calls_per_step": want_vjp,
          "launches": launches, "launches_by_shape": shape_table(shapes),
          "profiled_step": profiled,
          "peak_memory_gb": peak_gb,
          "checkpoint": {"step": back_step, "bytes": nbytes,
                         "save_s": save_s, "restore_s": restore_s,
                         "bit_equal": True},
          "grads_vs_plain": {"layers": case["check_layers"], **check}})
    return launches, shapes


def train_batch(cfg, B, S, index, seed):
    """Batch ``index`` of ``LMDataset(seed=0)`` (numpy); for the
    encoder-decoder also seeded frame embeddings [B, enc_seq, D], as the
    port's train parity test makes them."""
    from repro_torch.training.data import LMDataset
    batch = LMDataset(vocab_size=cfg.vocab_size, batch_size=B, seq_len=S,
                      seed=0).batch(index)
    if cfg.family == "enc_dec":
        batch["encoder_frames"] = np.random.default_rng(
            seed + index).standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def train_device_batch(cfg, host_batch):
    """The batch on the card, the frames in the activation dtype."""
    from repro_torch.configs.base import torch_dtype
    from repro_torch.launch import steps
    batch = steps.device_batch(host_batch, "cuda")
    if "encoder_frames" in batch:
        batch["encoder_frames"] = batch["encoder_frames"].to(
            torch_dtype(cfg.dtype))
    return batch


def schema_leaves(tree, path=()):
    """(path, element count) of every leaf of a parameter schema."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from schema_leaves(v, path + (k,))
        else:
            yield path + (k,), int(torch.Size(v.shape).numel())


def train_model_flops(model, B, S):
    """6 × (parameters a token meets) × tokens, summed over the token
    streams of one train step: every parameter over the B·S tokens of a
    dense model; of an MoE model the experts' weights count K/E (the
    top-k a token is routed to); of the encoder-decoder the encoder's
    layers and the decoder's cross-attention K/V projections run over
    the B·enc_seq frames and the rest over the B·S decoder tokens."""
    cfg = model.cfg
    leaves = list(schema_leaves(model.schema()))
    total = sum(n for _, n in leaves)
    if cfg.family == "moe":
        experts = sum(n for path, n in leaves if "moe" in path
                      and path[-1] in ("w_gate", "w_up", "w_down"))
        active = total - experts * (
            1 - cfg.num_experts_per_tok / cfg.num_experts)
        return 6 * active * B * S
    if cfg.family == "enc_dec":
        frames = sum(n for path, n in leaves if path[0] == "enc_layers"
                     or path[0] == "enc_final_norm"
                     or ("cross_attn" in path and path[-1] in ("wk", "wv")))
        return 6 * (frames * B * cfg.enc_seq + (total - frames) * B * S)
    return 6 * total * B * S


# ---------------------------------------------------------------------------
# phase 12: the replica fleet serving full-width stablelm-3b

# fig15's traffic (benchmarks/fig15_fleet.py): 4 sessions × 4 queries,
# each session's queries sharing a 160-character (160-token) prefix, 16
# new greedy tokens, 4 slots a replica; the card steps for real, so no
# step_sleep
FLEET_SESSIONS, FLEET_QUERIES, FLEET_PREFIX_CHARS = 4, 4, 160
FLEET_NEW = 16
FLEET_ENGINE = dict(max_slots=4, max_len=256, page_size=16, step_sleep=0.0,
                    prefix_cache_budget=256 << 20, device="cuda")
# (label, replicas, routing policy)
FLEETS = (("one_replica", 1, "prefix_affinity"),
          ("affinity", 4, "prefix_affinity"),
          ("least_outstanding", 4, "least_outstanding"))


def fleet_session_prefix(s):
    """fig15's per-session prefix: ``FLEET_PREFIX_CHARS`` characters."""
    base = (f"Session {s:02d} memory: the user is planning trip {s}, "
            f"prefers rail over air, budget tier {s % 3}. Context: ")
    out = base
    while len(out) < FLEET_PREFIX_CHARS:
        out += base
    return out[:FLEET_PREFIX_CHARS]


def fleet_prompts():
    """(priming, timed): one cold query a session, then every session's
    ``FLEET_QUERIES`` queries."""
    return ([fleet_session_prefix(s) + "Qwarm: ok"
             for s in range(FLEET_SESSIONS)],
            [fleet_session_prefix(s) + f"Q{q:02d}: next"
             for s in range(FLEET_SESSIONS) for q in range(FLEET_QUERIES)])


class TokenIds:
    """The byte tokenizer's encode with a lossless decode (the ids as
    text), so that what a fleet's dispatcher answers is the engine's
    tokens."""

    def __init__(self, vocab_size):
        from repro_torch.serving.tokenizer import ByteTokenizer
        self.byte = ByteTokenizer(vocab_size)
        self.vocab_size = vocab_size

    def encode(self, text):
        return self.byte.encode(text)

    def decode(self, ids):
        return " ".join(str(int(t)) for t in ids)

    @staticmethod
    def ids(text):
        return [int(t) for t in text.split()]


def fleet_wave(fleet, prompts):
    """``prompts`` dispatched one request each, concurrently, through the
    fleet's dispatcher; → (tokens per prompt, seconds to drain)."""
    async def go():
        outs = await asyncio.gather(*(
            fleet.dispatcher.generate(p, max_tokens=FLEET_NEW,
                                      temperature=0.0, stop=None)
            for p in prompts))
        await fleet.stop()
        return outs

    t0 = time.perf_counter()
    outs = asyncio.run(go())
    torch.cuda.synchronize()
    return [TokenIds.ids(o) for o in outs], time.perf_counter() - t0


def warm_counts(fleet):
    """Fleet-wide (probed, warm) from the per-replica route counters
    (``DispatchStats.note_route``)."""
    backends = fleet.stats.snapshot()["backends"]
    return (sum(b["prefix_probed"] for b in backends.values()),
            sum(b["prefix_hits"] for b in backends.values()))


def check_fleet_tokens(label, outs, warm_ref, cold_ref, all_warm):
    """Each request's greedy tokens must be the single engine's on the
    path the request took: over the primed prefix (``warm_ref``) or
    prefilled whole (``cold_ref``).  A fleet whose every request routed
    warm must give ``warm_ref`` exactly.  → the requests that gave the
    cold path's tokens where the two paths differ."""
    cold = 0
    for i, o in enumerate(outs):
        if o == warm_ref[i]:
            continue
        if o != cold_ref[i] or all_warm:
            fail(f"serve_fleet {label} request {i}: tokens {o} are neither "
                 f"the single engine's warm {warm_ref[i]} nor, routed cold, "
                 f"its cold {cold_ref[i]} (every request routed warm: "
                 f"{all_warm})")
        cold += 1
    return cold


def check_fleet_engines(label, fleet, launches, L):
    """Every replica's decode graph (one capture, a replay for each later
    step) and prefill shapes within the bucket bound; the paged decode
    kernel launched once a layer for every decode step of every replica
    and flash once a layer for every prefill chunk, nothing else."""
    steps = chunks = 0
    graphs = {}
    for name, e in zip(fleet.names, fleet.engines):
        st = e.stats()
        steps += st["steps"]
        chunks += st["prefill_chunks"]
        graphs[name] = check_graph(f"serve_fleet {label} {name}",
                                   st["decode_graph"], st["steps"],
                                   {"paged_decode_attention": L})
        if st["prefill_compilations"] > st["prefill_shape_bound"]:
            fail(f"serve_fleet {label} {name}: {st['prefill_compilations']} "
                 f"prefill shapes over the bound "
                 f"{st['prefill_shape_bound']}")
    check_launches(f"serve_fleet {label}", launches,
                   {"paged_decode_attention": L * steps,
                    "flash_attention": L * chunks})
    return graphs


def fleet_batch_wave(fleet, tok):
    """One ``generate_batch`` of a session's queries under the port's
    ``use_dispatcher``: its shared-prefix counts must land on the fleet's
    stats (the dispatcher binds itself around the backend call)."""
    from repro_torch.core.ai import use_dispatcher
    prompts = [fleet_session_prefix(0) + f"Qbatch{i}: go"
               for i in range(FLEET_QUERIES)]
    before = fleet.stats.snapshot()["prefix"] or {}

    async def go():
        with use_dispatcher(fleet.dispatcher):
            outs = await fleet.dispatcher.generate_batch(
                prompts, max_tokens=FLEET_NEW, temperature=0.0, stop=None)
        await fleet.stop()
        return outs

    outs = asyncio.run(go())
    after = fleet.stats.snapshot()["prefix"]
    grew = {k: after[k] - before.get(k, 0) for k in ("batches", "elements",
                                                     "shared_tokens")}
    if grew["batches"] != 1 or grew["elements"] != len(prompts) \
            or grew["shared_tokens"] <= 0:
        fail(f"serve_fleet: a generate_batch wave added {grew} to the "
             f"fleet's prefix-batch counts; want one batch of "
             f"{len(prompts)} elements sharing a prefix")
    for o in outs:
        ids = TokenIds.ids(o) if isinstance(o, str) else None
        if ids is None or len(ids) != FLEET_NEW \
                or not all(0 <= t < tok.vocab_size for t in ids):
            fail(f"serve_fleet: a generate_batch element gave {o!r}")
    return {**grew, "computed_tokens": after["computed_tokens"]
            - before.get("computed_tokens", 0)}


def phase_serve_fleet(seed):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.fleet import EngineFleet

    cfg = get_config("stablelm-3b")
    L = cfg.num_layers
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tok = TokenIds(cfg.vocab_size)
    priming, timed = fleet_prompts()

    # the single engine's tokens on both paths a request can take: over
    # its session's primed prefix (one session at a time, so that each
    # wave's prefill chunks are those of a replica holding that session
    # alone), and prefilled whole (no prefix cache)
    def engine_wave(engine, prompts):
        return serve_counted(engine, [tok.encode(p) for p in prompts],
                             FLEET_NEW, {})[0]

    warm_engine = ServingEngine(model, params, **FLEET_ENGINE)
    warm_ref = []
    for s in range(FLEET_SESSIONS):
        warm_engine.reset_prefix_cache()
        engine_wave(warm_engine, [priming[s]])
        warm_ref += engine_wave(
            warm_engine, timed[s * FLEET_QUERIES:(s + 1) * FLEET_QUERIES])
    cold_engine = ServingEngine(model, params,
                                **{**FLEET_ENGINE, "prefix_cache_budget": 0})
    cold_ref = engine_wave(cold_engine, timed)
    del warm_engine, cold_engine
    paths_differ = sum(w != c for w, c in zip(warm_ref, cold_ref))

    counters = launch_counters()
    launches, shapes, report, fleets = {}, {}, {}, {}
    for label, replicas, policy in FLEETS:
        fleet = EngineFleet(model, params, replicas=replicas, policy=policy,
                            tokenizer=tok, **FLEET_ENGINE)
        zero_launches(counters)
        primed, prime_s = fleet_wave(fleet, priming)
        p0, h0 = warm_counts(fleet)
        outs, drain_s = fleet_wave(fleet, timed)
        p1, h1 = warm_counts(fleet)
        got, got_shapes = read_launches(counters)
        if p1 - p0 != len(timed):
            fail(f"serve_fleet {label}: {p1 - p0} routed probes for "
                 f"{len(timed)} requests")
        warm_share = (h1 - h0) / (p1 - p0)
        graphs = check_fleet_engines(label, fleet, got, L)
        cold = check_fleet_tokens(label, outs, warm_ref, cold_ref,
                                  warm_share == 1.0)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)
        fleets[label] = fleet
        report[label] = {
            "replicas": replicas, "policy": policy,
            "priming_s": prime_s, "drain_s": drain_s,
            "warm_share": warm_share,
            "requests_on_the_cold_path": cold,
            "launches": {n: k for n, k in got.items() if k},
            "routed": {n: b["routed"] for n, b in
                       fleet.stats.snapshot()["backends"].items()},
            "graph": graphs, "engine_stats": fleet.engine_stats()}
    one = report["one_replica"]["drain_s"]
    for r in report.values():
        r["drain_ratio_vs_one_replica"] = one / r["drain_s"]
    # one replica holds all four sessions: the paged trie keys a node by
    # its first page, so sessions that share their first tokens coexist
    if report["one_replica"]["warm_share"] != 1.0:
        fail(f"serve_fleet: one replica's warm share "
             f"{report['one_replica']['warm_share']} != 1.0")
    if not report["affinity"]["warm_share"] \
            > report["least_outstanding"]["warm_share"]:
        fail(f"serve_fleet: prefix-affinity warm share "
             f"{report['affinity']['warm_share']} not above "
             f"least-outstanding's "
             f"{report['least_outstanding']['warm_share']}")

    affinity = fleets["affinity"]
    batch_wave = fleet_batch_wave(affinity, tok)
    # the affinity fleet's timed wave once more, under the profiler
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet_wave(affinity, timed)
        wall_us = (time.perf_counter() - t0) * 1e6
    profiled = profile_report(prof, wall_us, "serve_fleet_profile.txt")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve_fleet", "card": card(), "model": cfg.name,
          "layers": L, "params": model.num_params(), "dtype": "bfloat16",
          "init_s": init_s, "sessions": FLEET_SESSIONS,
          "queries_per_session": FLEET_QUERIES,
          "prefix_chars": FLEET_PREFIX_CHARS, "new_tokens": FLEET_NEW,
          "engine": {k: v for k, v in FLEET_ENGINE.items()
                     if k != "device"},
          "single_engine_paths_differ": paths_differ,
          "fleets": report, "generate_batch_wave": batch_wave,
          "profiled_wave": profiled, "peak_memory_gb": peak_gb})
    return launches, shapes


# phase 15: the paged engine over tensor-parallel meshes of this one card
SERVE_TP = (1, 2, 4)
SERVE_TP_F32_LAYERS = 4


def tp_engine(model, params, tp):
    """The serve phase's engine over a (1, tp) mesh of this card (no mesh
    at tp = 1)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import ServingEngine
    mesh = None if tp == 1 else make_serving_mesh(
        tp, devices=["cuda"] * tp)
    return ServingEngine(model, params, mesh=mesh, **SERVE_ENGINE)


def tp_prefill_ms(model, params, prefix, prompt):
    """Milliseconds of a cold 256-token prefill chunk and of a 128-token
    suffix over the 384-token prefix padded to 512, host work included,
    over ``params`` (a tree or an engine's sharded parameters); and the
    cold chunk's last logits."""
    toks = torch.tensor([prompt[:256]], dtype=torch.int32, device="cuda")
    pre = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    suf = torch.tensor([prompt[SERVE_PREFIX:SERVE_PREFIX + 128]],
                       dtype=torch.int32, device="cuda")
    with torch.no_grad():
        logits = model.prefill(params, {"tokens": toks}, capacity=256)[0]
        pfx = model.prefill(params, {"tokens": pre}, capacity=512)[1]
        return {
            "cold_256": call_ms(lambda: model.prefill(
                params, {"tokens": toks}, capacity=256), warmup=1, reps=5),
            "prefix512_suffix128": call_ms(lambda: model.prefill(
                params, {"tokens": suf}, capacity=128, prefix=pfx,
                prefix_len=SERVE_PREFIX), warmup=1, reps=5),
        }, logits.float()


def serve_tp_wave(cfg, model, params, tp, prefix, prompts, counters):
    """One engine at ``tp``: the warm-prefix fan-out with exact launches
    (``shards`` = tp), its decode graph, each shard's pool against the
    estimate, decode and prefill times.  → (outputs, report, launches,
    launches by key, first-chunk logits)."""
    from repro_torch.launch.dryrun import serving_kv_estimate
    from repro_torch.serving.prefix_cache import tree_nbytes
    engine = tp_engine(model, params, tp)
    outs, launches, shapes, serve_s = serve_counted(
        engine, prompts, 32, counters, warm=prefix)
    launches = {n: launches[n] for n in ("paged_decode_attention",
                                         "flash_attention")}
    st = engine.stats()
    graph = check_paged_serve(f"serve_tp tp={tp}", cfg, st, outs, launches,
                              shards=tp)
    est = serving_kv_estimate(cfg, max_slots=SERVE_ENGINE["max_slots"],
                              max_len=SERVE_ENGINE["max_len"],
                              page_size=SERVE_ENGINE["page_size"])
    pools = [tree_nbytes(engine.kv_pages)] if tp == 1 else \
        [tree_nbytes(t) for t in engine.kv_pages.values()]
    if pools != [est["paged_bytes"] // tp] * tp:
        fail(f"serve_tp tp={tp}: shard pools {pools} bytes, the estimate "
             f"{est['paged_bytes']} / {tp}")
    chunk_ms, logits = tp_prefill_ms(model, engine.params, prefix,
                                     prompts[-1])
    report = {"tp": tp, "serve_s": serve_s, **decode_stats(engine),
              "prefill_chunks": st["prefill_chunks"],
              "prefill_chunk_ms": chunk_ms, "launches": launches,
              "launches_by_shape": shape_table(shapes),
              "shard_pool_bytes": pools,
              "estimate_paged_bytes": est["paged_bytes"],
              "graph": graph}
    del engine
    return [list(o) for o in outs], report, launches, shapes, logits


def phase_serve_tp(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                          size=SERVE_PREFIX)]
    prompts = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                     size=n)]
               for n in SERVE_SUFFIXES]
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    base = base_logits = None
    launches, shapes, bf16 = {}, {}, []
    for tp in SERVE_TP:
        outs, rep, got, got_shapes, logits = serve_tp_wave(
            cfg, model, params, tp, prefix, prompts, counters)
        if tp == 1:
            base, base_logits = outs, logits
        rep["tokens_agreeing_with_tp1"] = sum(
            a == b for o, p in zip(outs, base) for a, b in zip(o, p))
        rep["tokens"] = sum(len(o) for o in outs)
        rep["prefill_logits_max_abs_diff_vs_tp1"] = float(
            (logits - base_logits).abs().max())
        bf16.append(rep)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params

    # float32 at 4 layers: the shards' sums may round differently, but
    # greedy tokens must not move
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                num_layers=SERVE_TP_F32_LAYERS)
    model32 = build_model(cfg32)
    params32 = model32.init(seed, device="cuda", dtype=torch.float32)
    f32, base = [], None
    for tp in SERVE_TP:
        outs, rep, got, got_shapes, logits = serve_tp_wave(
            cfg32, model32, params32, tp, prefix, prompts, counters)
        if tp == 1:
            base, base_logits = outs, logits
        elif outs != base:
            fail(f"serve_tp f32 tp={tp}: greedy tokens differ from tp = 1's")
        f32.append({"tp": tp, "tokens_equal_tp1": outs == base,
                    "prefill_logits_max_abs_diff_vs_tp1": float(
                        (logits - base_logits).abs().max()),
                    **{k: rep[k] for k in (
                        "decode_step_median_ms", "decode_step_p90_ms",
                        "launches", "shard_pool_bytes")}})
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)
    del params32
    emit({"phase": "serve_tp", "card": card(), "model": cfg.name,
          "layers": cfg.num_layers, "requests": len(prompts),
          "shards_on_one_card": True, "bfloat16": bf16,
          "float32": {"layers": SERVE_TP_F32_LAYERS, "by_tp": f32},
          "peak_memory_gb": peak_gb})
    return launches, shapes


# phase 16: the int8 error-feedback all-reduce over two data shards.
# Values of the gradient tree it reduces: stablelm-3b's leaves in order of
# size up to this many (all but the MLP's three: two calls' outputs over
# all 2.8 B values would not fit the card beside their inputs)
EF_VALUE_BUDGET = 1_200_000_000
EF_SHARDS = 2


def phase_ef_allreduce(seed):
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import build_model
    from repro_torch.training import compression as comp

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("stablelm-3b").replace(remat="full", microbatches=1)
    model = build_model(cfg)
    params = model.init(seed, device="cuda")
    B, S = TRAIN_CASES["train"]["batch"], TRAIN_CASES["train"]["seq"]
    grads = []
    for r in range(EF_SHARDS):    # shard r's batch: batch r of the stream
        batch = train_device_batch(cfg, train_batch(cfg, B, S, r, seed))
        grads.append(steps.loss_and_grads(model, params, batch)[2])
    del params, batch
    total = sum(g.numel() for g in grads[0].values())
    n_leaves = len(grads[0])
    keep, n = [], 0
    for k in sorted(grads[0], key=lambda k: grads[0][k].numel()):
        if n + grads[0][k].numel() > EF_VALUE_BUDGET:
            break
        keep.append(k)
        n += grads[0][k].numel()
    left_out = sorted(set(grads[0]) - set(keep))
    grads = [{k: g[k] for k in sorted(keep)} for g in grads]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = Mesh(np.array(["cuda"] * EF_SHARDS,
                         dtype=object).reshape(EF_SHARDS, 1),
                ("data", "model"))
    reduce = comp.make_compressed_dp_allreduce(mesh, "data")
    zeros = comp.init_error_buffers(grads[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means, errs = reduce(grads, [zeros] * EF_SHARDS)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del zeros
    # one int8 step of a chunk is its largest |value| over the shards / 127
    err_abs = exact_abs = grad_abs = 0.0
    for k in keep:
        exact = (grads[0][k] + grads[1][k]) / EF_SHARDS
        err_abs = max(err_abs, float((means[0][k] - exact).abs().max()))
        exact_abs = max(exact_abs, float(exact.abs().max()))
        grad_abs = max(grad_abs, *(float(g[k].abs().max()) for g in grads))
    resid = [math.sqrt(sum(float(e.double().square().sum())
                           for e in shard.values())) for shard in errs]
    grad_norm = math.sqrt(sum(float(g.double().square().sum())
                              for g in grads[0].values()))
    del means
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = reduce(grads, errs)
    torch.cuda.synchronize()
    second_ms = (time.perf_counter() - t0) * 1e3
    del out
    if not math.isfinite(err_abs) or err_abs > grad_abs / 127:
        fail(f"ef_allreduce: max abs error {err_abs} against the exact mean "
             f"exceeds one int8 step of the largest gradient ({grad_abs} / "
             f"127)")
    wire = sum(comp.wire_bytes(grads[0][k].numel()) for k in keep)
    emit({"phase": "ef_allreduce", "card": card(), "model": cfg.name,
          "shards": EF_SHARDS, "batch": [B, S], "chunk": 256,
          "leaves": len(keep), "leaves_of_tree": n_leaves,
          "values": n, "values_of_tree": total, "left_out": left_out,
          "max_abs_err_vs_exact_mean": err_abs,
          "max_abs_exact_mean": exact_abs,
          "residual_norm_per_shard": resid, "grad_norm_shard0": grad_norm,
          "wire_bytes": wire, "fp32_bytes": 4 * n,
          "wire_ratio": 4 * n / wire,
          "first_call_ms": first_ms, "ms_a_call": second_ms,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {}, {}


# phase 17: the families beyond serve_tp's dense one (MoE, the contiguous
# layout, the encoder-decoder at the model level), over tensor-parallel
# meshes of this one card
TP_FAMILY_TPS = (1, 2, 4)
# new tokens a request: half the single-device phases' 32, so that three
# engines a model fit the phase's time
TP_FAMILY_NEW = 16
# the reduced depths of the float32 check
TP_F32_DEPTH = {"olmoe-1b-7b": dict(num_layers=4),
                "recurrentgemma-9b": dict(num_layers=3),
                "mamba2-2.7b": dict(num_layers=4),
                "whisper-medium": dict(num_layers=2, enc_layers=2),
                "qwen3-14b": dict(num_layers=2)}
# recurrentgemma-9b's decode batch positions (serve_hybrid's, 16 tokens in)
# over its 2048-slot ring, the first two past the wrap
RG_TP_POS = [2114, 2044, 1514, 714, 314, 134, 54, 16]


def tp_family_kernel_rows(gen):
    """The kernels at the shard shapes of serve_tp_families: the decode
    kernel's partial entries (dense and int8) over one shard's slots of
    recurrentgemma-9b's ring (1024 and 512 of 2048) and the combine of
    the tp shards' stacked partials; the RG-LRU scan at W = 2048 and 1024
    and the SSD scan at 40 and 20 heads (a 2048-token prefill); whisper's
    decode attention at 8 heads.  (Paged decode and flash at olmoe-1b-7b's
    8 and 4 heads run with the other shard shapes.)"""
    rows = []
    for tp in (2, 4):
        for dname, dtype in (("bfloat16", torch.bfloat16),
                             ("float32", torch.float32)):
            for kname in ("decode_attention_partial",
                          "decode_attention_int8_partial"):
                rows += decode_split_rows(gen, kname, tp, dname, dtype)
        rows += rglru_rows(gen, 4096 // tp, f"recurrentgemma-9b/tp{tp}",
                           ((1, 2100, False),))
        rows += ssd_kernel_rows(gen, H=80 // tp, shape=f"mamba2-2.7b/tp{tp}",
                                cases=((2048, False, "init"),))
    w = WHISPER_ATTN
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        for case, C, pos in (
                ("decode self", w["C"], [447, 300, 129, 67, 64, 63, 4, 0]),
                ("decode cross", w["T"], None)):
            rows.append(decode_kernel_row(
                gen, "decode_attention", "whisper-medium/tp2",
                dict(B=w["B"], H=w["H"] // 2, KVH=w["KVH"] // 2, d=w["d"],
                     C=C, pos=pos), dname, dtype, case=case))
    return rows


# the shapes of serve_tp_fallbacks: qwen3-14b's runs of q heads over its
# replicated KV heads at tp = 5 (G 5, 3, 2 and 1 over one KV head of 128,
# G 4 over two), each read in place from the pool of all 8 KV heads at
# the first run of its shape (``kv_lo``), and whisper-medium's cross
# memory split three ways
QWEN3_TP5_RUNS = {f"qwen3-14b/tp5 run {h}:{kvh}": dict(H=h, KVH=kvh, d=128,
                                                      pool_kvh=8, kv_lo=lo)
                  for h, kvh, lo in ((5, 1, 0), (3, 1, 1), (2, 1, 1),
                                     (1, 1, 4), (8, 2, 3))}
WHISPER_CROSS = dict(B=8, H=16, KVH=16, d=64, C=1500, pos=None)


def fallback_kernel_rows(gen):
    """The kernels at the shapes of serve_tp_fallbacks beyond the earlier
    phases': the paged decode kernel at each run of qwen3-14b's q heads
    at tp = 5 (one launch a run, the run's KV heads read in place from
    the whole pool), and the decode kernel's partial entry over one
    shard's 500 of whisper-medium's 1500 cross-memory frames with the
    combine of the three shards' partials.  (The whole rings and the
    replicated scans run at the one-device shapes of the kernels phase.)
    The decode wrappers on a cache narrowed to a run of heads are held
    against their plain versions too (:func:`check_decode_head_views`)."""
    rows = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        check_decode_head_views(gen, dname, dtype)
        for sname, sh in QWEN3_TP5_RUNS.items():
            rows.append(paged_row(gen, sname, sh, dname, dtype,
                                  cases=False))
        rows += decode_split_rows(gen, "decode_attention_partial", 3, dname,
                                  dtype, sh=WHISPER_CROSS,
                                  model="whisper-medium cross")
    return rows


def check_decode_head_views(gen, dname, dtype):
    """The decode wrappers (dense, int8 and the dense partial entry) over
    a cache of 8 KV heads of 128 narrowed to heads [3, 5), read in place,
    against their plain versions on the same view (qwen3-14b's run of 8
    q heads over two KV heads at tp = 5, on a 512-slot cache)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.models.attention import quantize_kv

    B, C, S, lo, hi, H, d = 8, 512, 8, 3, 5, 8, 128
    q = torch.randn(B, 1, H, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, C, S, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, C, S, d, generator=gen, device="cuda").to(dtype)
    valid = torch.rand(B, C, generator=gen, device="cuda") < 0.8
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    dense = (q, k[:, :, lo:hi], v[:, :, lo:hi], valid)
    int8 = (q, k8[:, :, lo:hi], v8[:, :, lo:hi], ks[:, :, lo:hi],
            vs[:, :, lo:hi], valid)
    errs = {}
    for name, fn, ref, args in (
            ("decode_attention", da_ops.decode_attention,
             da_ref.decode_attention_ref, dense),
            ("decode_attention_int8", da_ops.decode_attention_int8,
             da_ref.decode_attention_int8_ref, int8)):
        errs[name] = check_close(f"{name} on a head view {dname}",
                                 fn(*args), ref(*args), dname)
    chunk, _ = da_ops.launch_plan(q, dense[1])
    errs["decode_attention_partial"] = check_close(
        f"decode_attention_partial on a head view {dname}",
        partial_view(*da_ops.decode_attention_partial(*dense)),
        partial_view(*da_ref.decode_partial_ref(*dense, chunk=chunk)), dname)
    emit({"phase": "kernels", "decode_head_views": dname,
          "shape": dict(B=B, C=C, pool_kvh=S, kv_heads=[lo, hi], H=H, d=d),
          "max_abs_err": errs, "tol": TOL[dname]})


def partial_view(acc, ml):
    """Partials as what does not depend on their scale: each split's
    normalised output and its log-sum-exp (-1e30 for an empty split)."""
    m, l = ml[..., 0], ml[..., 1]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(m, -1e30))
    return torch.cat([(acc / l.clamp_min(1e-30)[..., None]).flatten(),
                      lse.flatten().clamp_min(-1e4)])


# recurrentgemma-9b's ring, at serve_hybrid's decode positions
RG_RING = dict(B=8, H=16, KVH=1, d=256, C=2048, pos=RG_TP_POS)


def decode_split_rows(gen, kname, tp, dname, dtype, *, sh=RG_RING,
                      model="recurrentgemma-9b"):
    """A cache of ``sh`` (B, H, KVH, d, C slots, the batch rows' positions
    ``pos`` of a ring, or None: every slot valid) split by sequence
    ``tp`` ways: the partial entry ``kname`` over shard 0's slots against
    its plain version at the kernel's chunk plan (each split's normalised
    output and log-sum-exp), NaN in the invalid slots changing nothing;
    then the combine (``decode_combine``) of all tp shards' partials
    against the plain combine, and the merged output against the unsplit
    plain decode.  Library call of the partial row: SDPA over the shard's
    slots (it normalises, so it computes the partial's output alone)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.models.attention import dequantize_kv, quantize_kv

    B, H, KVH, d, C = (sh[k] for k in ("B", "H", "KVH", "d", "C"))
    Cl = C // tp
    shape = f"{model}/tp{tp}"
    valid = torch.ones(B, C, dtype=torch.bool, device="cuda") \
        if sh["pos"] is None else ring_valid(sh["pos"], C)
    q = torch.randn(B, 1, H, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, C, KVH, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, C, KVH, d, generator=gen, device="cuda").to(dtype)
    int8 = "int8" in kname
    if int8:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        cache = (k8, v8, ks, vs)
        fn, ref_fn = da_ops.decode_attention_int8_partial, \
            da_ref.decode_partial_int8_ref
        full_ref = da_ref.decode_attention_int8_ref
    else:
        cache = (k, v)
        fn, ref_fn = da_ops.decode_attention_partial, da_ref.decode_partial_ref
        full_ref = da_ref.decode_attention_ref

    def shard(r):
        return tuple(t[:, r * Cl:(r + 1) * Cl].contiguous()
                     for t in (*cache, valid))
    args = (q, *shard(0))
    chunk, n_split = da_ops.launch_plan(q, args[1])
    label = f"{kname} {shape} {dname}"
    got = fn(*args)
    err = check_close(label, partial_view(*got),
                      partial_view(*ref_fn(*args, chunk=chunk)), dname)
    poisoned = [a.clone() for a in args]
    vr = args[-1]
    for t in (poisoned[3:5] if int8 else poisoned[1:3]):
        t[~vr] = float("nan")
    if not all(torch.equal(a, b) for a, b in zip(fn(*poisoned), got)):
        fail(f"{label}: NaN in invalid slots changed the partials")

    def library(q, *rest, dtype=dtype):
        kk, vv, valid = rest[0], rest[1], rest[-1]
        if int8:
            kk = dequantize_kv(kk, rest[2], dtype)
            vv = dequantize_kv(vv, rest[3], dtype)
        return sdpa(q.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2), valid[:, None, None, :])

    n_valid = int(vr.sum().item())
    b_ms, b_by = bound(*da_ops.decode_attention_work(
        q, args[1], n_valid, int8=int8, n_split=n_split), dname)
    rows = [dict(
        kernel=kname, shape=shape, dtype=dname, B=B, H=H, KVH=KVH, d=d,
        C=Cl, of_slots=C, positions=sh["pos"], valid_rows=n_valid,
        chunk=chunk, n_split=n_split, launch_key=dict(da_ops.launch_key(
            q, args[1])), max_abs_err=err, tol=TOL[dname],
        compared="each split's normalised output and log-sum-exp",
        **kernel_times(fn, lambda *a: ref_fn(*a, chunk=chunk), library,
                       args),
        bound_ms=b_ms, bound_by=b_by)]
    if int8:        # one combine row a dtype and tp: under the dense rows
        return rows
    parts = [fn(q, *shard(r)) for r in range(tp)]
    acc = torch.cat([a for a, _ in parts], 2)
    ml = torch.cat([m for _, m in parts], 2)
    out = da_ops.decode_combine(acc, ml, dtype)
    cerr = check_close(f"decode_combine {shape} {dname}", out,
                       da_ref.decode_combine_ref(acc, ml, dtype), dname)
    unsplit = check_close(f"decode split {shape} {dname} vs unsplit", out,
                          full_ref(q, *cache, valid), dname)
    b_ms, b_by = bound(*da_ops.decode_combine_work(acc, dtype), "float32")
    rows.append(dict(
        kernel="decode_combine", shape=shape, dtype=dname, B=B, H=H, d=d,
        n_split=acc.shape[2], shards=tp,
        launch_key=dict(da_ops.combine_key(acc, dtype)), max_abs_err=cerr,
        merged_vs_unsplit_decode_err=unsplit, tol=TOL[dname],
        **kernel_times(lambda a, m: da_ops.decode_combine(a, m, dtype),
                       lambda a, m: da_ref.decode_combine_ref(a, m, dtype),
                       None, (acc, ml)),
        library_note="no single PyTorch call merges softmax partials",
        bound_ms=b_ms, bound_by=b_by))
    return rows


def tp_family_engine(model, params, tp, kw):
    """An engine of ``model`` over a (1, tp) mesh of this card (no mesh at
    tp = 1)."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving.engine import ServingEngine
    mesh = None if tp == 1 else make_serving_mesh(tp,
                                                  devices=["cuda"] * tp)
    return ServingEngine(model, params, mesh=mesh, **{"device": "cuda", **kw})


def shard_cache_bytes(engine):
    """Each shard's decode-cache bytes (the page pool or the slot cache)."""
    from repro_torch.serving.prefix_cache import tree_nbytes
    tree = engine.kv_pages if engine.paged_kv else engine.cache
    if engine.mesh is None:
        return [tree_nbytes(tree)]
    return [tree_nbytes(t) for t in tree.values()]


def engine_cache_layout(engine):
    """(each shard's cache tree, the whole cache as ``meta`` tensors, its
    specs under the serving rules) of a sharded engine: the page pool or
    the slot cache."""
    from repro_torch.models import lm
    from repro_torch.sharding.rules import cache_pspecs
    if engine.paged_kv:
        meta = engine.model.init_paged_cache(
            engine.num_pages + 1, engine.page_size, device="meta")
        return (list(engine.kv_pages.values()), meta,
                cache_pspecs(engine._rules, meta, layout="paged"))
    meta, specs = lm.cache_layout_tp(engine.cfg, engine.params,
                                     engine.max_slots, engine.max_len)
    return list(engine.cache.values()), meta, specs


def tree_items(tree, prefix=()):
    """(path, leaf) of a tree of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_local_shapes(label, shards, meta, specs):
    """Every shard's cache leaf (``shards[r]``, a tree) at the local shape
    the serving rules' ``specs`` give the whole cache ``meta``."""
    from repro_torch.sharding.rules import local_shape
    whole, sp = dict(tree_items(meta)), dict(tree_items(specs))
    sizes = {"data": 1, "model": len(shards)}
    for r, tree in enumerate(shards):
        got = {p: tuple(t.shape) for p, t in tree_items(tree)}
        want = {p: tuple(local_shape(t.shape, sp[p], sizes))
                for p, t in whole.items()}
        if got != want:
            fail(f"{label}: shard {r}'s cache leaves {got}, the rules' "
                 f"local shapes {want}")


def replicated_equal(label, shards, meta, specs):
    """Every leaf that ``specs`` replicates (no ``model`` entry) must be
    bit-equal across the shards' trees; → how many such leaves."""
    leaves = [dict(tree_items(t)) for t in shards]
    n = 0
    for path, spec in tree_items(specs):
        if "model" in tuple(spec):
            continue
        n += 1
        if not all(torch.equal(lv[path], leaves[0][path])
                   for lv in leaves[1:]):
            fail(f"{label}: replicated cache leaf {'/'.join(path)} differs "
                 f"across the shards")
    return n


def tp_family_wave(label, spec, model, params, tp, counters):
    """One engine of a family at ``tp``: ``spec`` gives its engine
    arguments, prompts, warm prefix, the cache estimate and the exact
    launches a decode step and an admission make (``per_step(tp)``,
    ``per_admission(tp)``).  Holds the launches, the decode graph, each
    shard's cache bytes against the local shapes of the serving rules'
    ``cache_pspecs`` (the estimate at tp = 1) and every cache leaf the
    rules replicate bit-equal across the shards; → (outputs, report,
    launches, launches by key, the prefill's last logits)."""
    import gc
    engine = tp_family_engine(model, params, tp, spec["engine"])
    outs, launches, shapes, serve_s = serve_counted(
        engine, spec["prompts"], TP_FAMILY_NEW, counters, warm=spec["warm"])
    st = engine.stats()
    per_step, per_adm = spec["per_step"](tp), spec["per_admission"](tp)
    want = {n: per_step.get(n, 0) * st["steps"]
            + per_adm.get(n, 0) * st["prefill_chunks"]
            for n in set(per_step) | set(per_adm)}
    check_launches(f"{label} tp={tp}", launches, want)
    graph = check_graph(f"{label} tp={tp}", st["decode_graph"], st["steps"],
                        per_step)
    for i, o in enumerate(outs):
        if len(o) != TP_FAMILY_NEW or not all(
                0 <= t < model.cfg.vocab_size for t in o):
            fail(f"{label} tp={tp} request {i}: {len(o)} tokens, or one "
                 f"outside the vocab")
    caches = shard_cache_bytes(engine)
    replicated = 0
    if tp > 1:
        layout = engine_cache_layout(engine)
        check_local_shapes(f"{label} tp={tp}", *layout)
        replicated = replicated_equal(f"{label} tp={tp}", *layout)
    # every leaf split: each shard holds 1/tp of the estimate
    if not replicated and caches != [spec["estimate"] // tp] * tp:
        fail(f"{label} tp={tp}: shard caches of {caches} bytes, the "
             f"estimate {spec['estimate']} / {tp}")
    toks = torch.tensor([spec["prefill"]], dtype=torch.int32, device="cuda")
    cap = spec["prefill_capacity"]
    with torch.no_grad():
        logits = model.prefill(engine.params, {"tokens": toks},
                               capacity=cap)[0][..., :model.cfg.vocab_size]
        logits = logits.float()
        prefill_ms = call_ms(lambda: model.prefill(
            engine.params, {"tokens": toks}, capacity=cap), warmup=1, reps=3)
    report = {"tp": tp, "serve_s": serve_s, **decode_stats(engine),
              "admissions": st["prefill_chunks"],
              f"prefill_{toks.shape[1]}_tokens_ms": prefill_ms,
              "launches": {n: k for n, k in launches.items() if k},
              "launches_per_step": graph["launches_per_replay"],
              "shard_cache_bytes": caches,
              "estimate_cache_bytes": spec["estimate"],
              "replicated_leaves_bit_equal": replicated, "graph": graph}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return [list(o) for o in outs], report, launches, shapes, logits


def tp_family_specs(cfg, seed):
    """Per family: its engine, traffic and exact launch counts (the
    existing serve phases' traffic)."""
    from repro_torch.launch.dryrun import serving_kv_estimate
    from repro_torch.models import lm
    from repro_torch.serving.prefix_cache import tree_nbytes
    rng = np.random.RandomState(seed)
    V = cfg.vocab_size
    if cfg.family in ("moe", "dense"):
        prefix = [int(t) for t in rng.randint(0, V, size=SERVE_PREFIX)]
        prompts = [prefix + [int(t) for t in rng.randint(0, V, size=n)]
                   for n in SERVE_SUFFIXES]
        L = cfg.num_layers
        est = serving_kv_estimate(cfg, max_slots=SERVE_ENGINE["max_slots"],
                                  max_len=SERVE_ENGINE["max_len"],
                                  page_size=SERVE_ENGINE["page_size"])
        return dict(engine=SERVE_ENGINE, prompts=prompts, warm=prefix,
                    estimate=est["paged_bytes"], prefill=prompts[-1][:256],
                    prefill_capacity=256,
                    per_step=lambda tp: {
                        "paged_decode_attention": L * attention_runs(cfg,
                                                                     tp)},
                    per_admission=lambda tp: {
                        "flash_attention": L * attention_runs(cfg, tp)})
    lens = HYBRID_PROMPTS if cfg.family == "hybrid" else SSM_PROMPTS
    prompts = [[int(t) for t in rng.randint(0, V, size=n)] for n in lens]
    kinds = lm.block_kinds(cfg)
    n_attn = sum(k == "attn_mlp_local" for k in kinds)
    n_rec = len(kinds) - n_attn
    int8 = cfg.kv_cache_dtype == "int8"

    def per_step(tp):
        if not n_attn:
            return {}
        ring = min(MAX_LEN, cfg.attn_window or MAX_LEN)
        if tp == 1 or cfg.num_kv_heads % tp == 0 or ring % tp:
            # one launch a shard: its KV heads, or the whole ring
            return {"decode_attention_int8" if int8 else "decode_attention":
                    n_attn * tp}
        return {"decode_attention_int8_partial" if int8
                else "decode_attention_partial": n_attn * tp,
                "decode_combine": n_attn}

    def per_admission(tp):
        if cfg.family == "ssm":
            return {"ssd_chunk_scan": n_rec * tp}
        return {"flash_attention": n_attn * tp, "rglru_scan": n_rec * tp}
    return dict(engine=dict(max_slots=8, max_len=MAX_LEN), prompts=prompts,
                warm=None, estimate=tree_nbytes(lm.init_cache(
                    cfg, 8, MAX_LEN, "meta")),
                prefill=prompts[0], prefill_capacity=MAX_LEN,
                per_step=per_step, per_admission=per_admission)


def attention_runs(cfg, tp):
    """Attention launches a layer over ``tp`` shards, counted here from
    the GQA mapping alone (q head h reads KV head h // G, G = H / KVH):
    one a shard where the heads are whole or the KV heads split; where
    the q heads split over replicated KV heads, one a run of equal group
    sizes among the shard's KV heads (qwen3-14b at tp = 5: 2, 3, 1, 3
    and 2, 11 in all)."""
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    if tp == 1 or H % tp or KVH % tp == 0:
        return tp
    G, Hl = H // KVH, H // tp
    n = 0
    for r in range(tp):
        sizes = collections.Counter(h // G for h in range(r * Hl,
                                                          (r + 1) * Hl))
        seq = [sizes[kv] for kv in sorted(sizes)]
        n += 1 + sum(a != b for a, b in zip(seq, seq[1:]))
    return n


def tp_family_model(label, cfg, seed, counters, *, tps=TP_FAMILY_TPS,
                    prompts=None):
    """A full-width bf16 family at each tp, then the float32 check at its
    reduced depth: tokens equal to tp = 1's and the prefill's logits
    within LOGITS_TOL_F32 relative L2.  → (report, launches, shapes)."""
    import gc

    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    def specs(cfg):
        spec = tp_family_specs(cfg, seed)
        if prompts is not None:
            spec["prompts"] = [spec["prompts"][i] for i in prompts]
            spec["prefill"] = spec["prompts"][0]
        return spec
    spec = specs(cfg)
    launches, shapes, bf16, base = {}, {}, [], None
    for tp in tps:
        outs, rep, got, got_shapes, logits = tp_family_wave(
            label, spec, model, params, tp, counters)
        if tp == tps[0]:
            base, base_logits = outs, logits
        pairs = [(a, b) for o, p in zip(outs, base) for a, b in zip(o, p)]
        rep["tokens_equal_tp1_share"] = sum(a == b for a, b in pairs) \
            / len(pairs)
        rep["prefill_logits_rel_l2_vs_tp1"] = rel_l2(logits, base_logits)
        bf16.append(rep)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                **TP_F32_DEPTH[cfg.name])
    m32 = build_model(cfg32)
    p32 = m32.init(seed, device="cuda", dtype=torch.float32)
    f32, base = [], None
    for tp in tps:
        outs, rep, _, _, logits = tp_family_wave(
            f"{label} f32", specs(cfg32), m32, p32, tp, counters)
        if tp == tps[0]:
            base, base_logits = outs, logits
        err = rel_l2(logits, base_logits)
        if outs != base or not err <= LOGITS_TOL_F32:
            fail(f"{label} f32 tp={tp}: tokens equal {outs == base}, "
                 f"prefill logits rel L2 {err} vs tp = 1 (tol "
                 f"{LOGITS_TOL_F32})")
        f32.append({"tp": tp, "tokens_equal_tp1": True,
                    "prefill_logits_rel_l2_vs_tp1": err,
                    **{k: rep[k] for k in ("decode_step_median_ms",
                                           "launches_per_step",
                                           "shard_cache_bytes")}})
    del p32
    return ({"model": cfg.name, "layers": cfg.num_layers,
             "kv_cache_dtype": cfg.kv_cache_dtype or "activation",
             "bfloat16": bf16,
             "float32": {"depth": TP_F32_DEPTH[cfg.name], "by_tp": f32},
             "peak_memory_gb": peak_gb}, launches, shapes)


def tp_encdec(cfg, seed, counters, *, tps=(1, 2)):
    """whisper-medium at the model level over sharded parameters: the
    encdec phase's batch, prefill and TP_FAMILY_NEW greedy decode steps at
    each tp, exact launches (per shard: flash for each encoder layer and
    each decoder layer's self- and cross-attention; a step, for each
    decoder layer's two attentions, decode attention a shard where the
    cache splits by KV heads or is whole on every shard, else the partial
    a shard and one combine), each shard's cache at the serving rules'
    local shapes and the leaves they replicate bit-equal across shards;
    then float32 at 2 + 2 layers, tokens equal to tp = 1's."""
    import gc

    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import build_model, encdec
    from repro_torch.sharding.placement import ShardedParams
    from repro_torch.sharding.rules import (cache_pspecs, make_serving_rules,
                                            params_pspecs)

    def decode_launches(cfg, tp):
        L, steps = cfg.num_layers, TP_FAMILY_NEW
        out = collections.Counter()
        for slots in (ENCDEC_CAPACITY, cfg.enc_seq):   # self, cross
            if tp == 1 or cfg.num_kv_heads % tp == 0 or slots % tp:
                out["decode_attention"] += L * tp * steps
            else:
                out["decode_attention_partial"] += L * tp * steps
                out["decode_combine"] += L * steps
        return dict(out)

    def run(model, params, dtype, tp, label):
        cfg = model.cfg
        if tp > 1:
            mesh = make_serving_mesh(tp, devices=["cuda"] * tp)
            rules = make_serving_rules(mesh, cfg)
            params = ShardedParams(params, params_pspecs(rules, model), mesh)
            meta = encdec.init_cache(cfg, ENCDEC_BATCH, ENCDEC_CAPACITY,
                                     "meta")
            specs = cache_pspecs(rules, meta)
        batch = encdec_inputs(cfg, seed, dtype)
        zero_launches(counters)
        t0 = time.perf_counter()
        toks, step_s, cache, _ = encdec_greedy(model, params, batch,
                                               TP_FAMILY_NEW)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, shapes = read_launches(counters)
        L, E = cfg.num_layers, cfg.enc_layers
        check_launches(label, launches, {
            "flash_attention": (E + 2 * L) * tp, **decode_launches(cfg, tp)})
        with torch.no_grad():
            logits = model.prefill(params, batch, ENCDEC_CAPACITY)[0]
            logits = logits[..., :cfg.vocab_size].float()
            prefill_ms = call_ms(lambda: model.prefill(
                params, batch, ENCDEC_CAPACITY), warmup=1, reps=3)
        caches = [sum(t.numel() * t.element_size() for t in c["dec"].values())
                  for c in (cache.values() if tp > 1 else [cache])]
        replicated = 0
        if tp > 1:
            check_local_shapes(label, list(cache.values()), meta, specs)
            replicated = replicated_equal(label, list(cache.values()), meta,
                                          specs)
        dec = sorted(step_s)
        rep = {"tp": tp, "seconds": seconds, "prefill_ms": prefill_ms,
               "decode_step_median_ms": statistics.median(dec) * 1e3,
               "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
               "launches": {n: k for n, k in launches.items() if k},
               "shard_cache_bytes": caches,
               "replicated_leaves_bit_equal": replicated}
        del cache, params
        return toks, logits, rep, launches, shapes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    launches, shapes, bf16 = {}, {}, []
    for tp in tps:
        toks, logits, rep, got, got_shapes = run(
            model, params, torch.bfloat16, tp, f"tp_encdec tp={tp}")
        if tp == tps[0]:
            base, base_logits = toks, logits
        rep["tokens_equal_tp1_share"] = float((toks == base).float().mean())
        rep["prefill_logits_rel_l2_vs_tp1"] = rel_l2(logits, base_logits)
        whole = bf16[0]["shard_cache_bytes"][0] if bf16 \
            else rep["shard_cache_bytes"][0]
        if not rep["replicated_leaves_bit_equal"] \
                and rep["shard_cache_bytes"] != [whole // tp] * tp:
            fail(f"tp_encdec tp={tp}: shard caches of "
                 f"{rep['shard_cache_bytes']} bytes, tp = 1's {whole} / {tp}")
        bf16.append(rep)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    m32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                          **TP_F32_DEPTH[cfg.name]))
    p32 = m32.init(seed, device="cuda", dtype=torch.float32)
    f32 = []
    for tp in tps:
        toks, logits, rep, _, _ = run(m32, p32, torch.float32, tp,
                                      f"tp_encdec f32 tp={tp}")
        if tp == tps[0]:
            base, base_logits = toks, logits
        err = rel_l2(logits, base_logits)
        if not torch.equal(toks, base) or not err <= LOGITS_TOL_F32:
            fail(f"tp_encdec f32 tp={tp}: tokens equal "
                 f"{torch.equal(toks, base)}, prefill logits rel L2 {err}")
        f32.append({"tp": tp, "tokens_equal_tp1": True,
                    "prefill_logits_rel_l2_vs_tp1": err})
    del p32
    return ({"model": cfg.name, "layers": [cfg.enc_layers, cfg.num_layers],
             "level": "model", "bfloat16": bf16,
             "float32": {"depth": TP_F32_DEPTH[cfg.name], "by_tp": f32},
             "peak_memory_gb": peak_gb}, launches, shapes)


def phase_serve_tp_families(seed):
    from repro_torch.configs import get_config
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.sharding.placement import regroup

    counters = launch_counters()
    launches, shapes, models = {}, {}, []

    def add(rep, got, got_shapes):
        nonlocal launches, shapes
        models.append(rep)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)

    add(*tp_family_model("tp_moe", get_config("olmoe-1b-7b"), seed,
                         counters))
    rg = get_config("recurrentgemma-9b")
    add(*tp_family_model("tp_hybrid", rg, seed, counters))
    add(*tp_family_model("tp_hybrid_int8",
                         dataclasses.replace(rg, kv_cache_dtype="int8"),
                         seed, counters, tps=(1, 2),
                         prompts=[HYBRID_PROMPTS.index(n)
                                  for n in HYBRID_INT8_PROMPTS]))
    copies = (regroup.pieces, regroup.copies)
    add(*tp_family_model("tp_ssm", get_config("mamba2-2.7b"), seed,
                         counters))
    models[-1]["reshard"] = {"pieces": regroup.pieces - copies[0],
                             "copies_from_other_shards":
                             regroup.copies - copies[1]}
    add(*tp_encdec(get_config("whisper-medium"), seed, counters))
    emit({"phase": "serve_tp_families", "card": card(),
          "shards_on_one_card": True, "new_tokens": TP_FAMILY_NEW,
          "models": models})
    return launches, shapes


# serve_tp_fallbacks: full-width models over a shard count that some of
# their widths do not divide, every shard on this card; qwen3-14b cut to
# QWEN3_TP5_LAYERS of its 40 layers to keep the phase short (the phase
# prints its peak memory), its float32 check at the same depth
FALLBACK_TP = 3
QWEN3_TP = 5
QWEN3_TP5_LAYERS = 2


def phase_serve_tp_fallbacks(seed):
    """The layouts the serving rules give where a width does not divide
    the shard count, through the normal entry points: recurrentgemma-9b
    (dense and int8 KV; only the MLPs split: RG-LRU's 4096 columns, the
    16 q heads and the 2048-slot ring are whole on every shard),
    mamba2-2.7b (only the conv's 5376 columns split) and whisper-medium at
    the model level (every weight whole, the 1500-frame cross memory
    split by sequence) over three shards; qwen3-14b on the paged engine
    over five (8 q heads a shard over the 8 replicated KV heads, read in
    runs of equal groups).  Each at tp = 1 and at its tp: bf16 at full
    width, then the float32 check (tokens equal to tp = 1's)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.sharding.placement import regroup

    counters = launch_counters()
    launches, shapes, models = {}, {}, []

    def add(rep, got, got_shapes):
        nonlocal launches, shapes
        models.append(rep)
        launches = {n: launches.get(n, 0) + got.get(n, 0)
                    for n in set(launches) | set(got)}
        shapes = add_shapes(shapes, got_shapes)

    tps = (1, FALLBACK_TP)
    rg = get_config("recurrentgemma-9b")
    add(*tp_family_model("fb_hybrid", rg, seed, counters, tps=tps))
    add(*tp_family_model("fb_hybrid_int8",
                         dataclasses.replace(rg, kv_cache_dtype="int8"),
                         seed, counters, tps=tps,
                         prompts=[HYBRID_PROMPTS.index(n)
                                  for n in HYBRID_INT8_PROMPTS]))
    copies = (regroup.pieces, regroup.copies)
    add(*tp_family_model("fb_ssm", get_config("mamba2-2.7b"), seed,
                         counters, tps=tps))
    models[-1]["reshard"] = {"pieces": regroup.pieces - copies[0],
                             "copies_from_other_shards":
                             regroup.copies - copies[1]}
    add(*tp_encdec(get_config("whisper-medium"), seed, counters, tps=tps))
    qwen = dataclasses.replace(get_config("qwen3-14b"),
                               num_layers=QWEN3_TP5_LAYERS)
    add(*tp_family_model("fb_qwen3", qwen, seed, counters,
                         tps=(1, QWEN3_TP)))
    models[-1]["cut"] = f"{QWEN3_TP5_LAYERS} of 40 layers"
    emit({"phase": "serve_tp_fallbacks", "card": card(),
          "shards_on_one_card": True, "new_tokens": TP_FAMILY_NEW,
          "models": models})
    return launches, shapes


# the fields that tell a kernel's rows apart, in the summary line
ROW_KEYS = ("shape", "case", "dtype", "B", "S", "T", "C", "prefix_pad",
            "prefix_len", "window", "h0", "decay", "n_split")


# ---------------------------------------------------------------------------
# phase 18: the sharded train step, every coordinate on this card

TRAIN_TP = dict(arch="stablelm-3b", batch=4, seq=1024, layers=8,
                meshes=((1, 1), (2, 1), (1, 2), (2, 2)),
                why="8 of 32 layers: at 32 the (2, 2) mesh's placed train "
                    "state beside the single-device state it is placed "
                    "from, the (1, 1) step's gradients kept for comparison "
                    "and a layer's gathered weights would not fit one "
                    "card; 8 rather than the 16 that fit keeps the whole "
                    "script well inside its time limit")
TRAIN_TP_ULYSSES = dict(arch="qwen3-14b", batch=1, seq=1024, layers=2,
                        meshes=((1, 1), (1, 16)),
                        why="2 of 40 layers: 16 coordinates each gather a "
                            "layer's whole weights (ulysses_sp), and the "
                            "vocab tables of 151,936 rows take 6.2 GB of "
                            "f32 state a table")
TRAIN_TP_STEPS = 4          # the first warms up and is not timed
TRAIN_TP_CHECK_LAYERS = 2
# float32 at TRAIN_TP_CHECK_LAYERS layers: loss and each gradient leaf's
# relative L2 against the (1, 1) step's (the rows' and shards' partial
# sums add in another order than one device's products)
TRAIN_TP_TOL_F32 = 1e-5


def ulysses_flash_rows(gen):
    """Flash's prefix form at qwen3-14b's ulysses_sp shard on a (1, 16)
    mesh: the last shard's 64 query rows of 40 heads of 128 over the
    1024 all-gathered keys of 8 KV heads, ``prefix_pad = prefix_len =
    960`` (the causal offset of its rows), against its plain version,
    with its bound, the plain version's time and SDPA's with the same
    mask."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)
    rows = []
    S, T, H, KVH, d, off = 64, 1024, 40, 8, 128, 960
    kw = dict(causal=True, prefix_pad=off, prefix_len=off)
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        q = torch.randn(1, S, H, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(1, T, KVH, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(1, T, KVH, d, generator=gen, device="cuda").to(dtype)
        label = f"flash qwen3-14b/ulysses16 {dname}"
        out = fa_ops.flash_attention(q, k, v, **kw)
        err = check_close(label, out, flash_attention_ref(q, k, v, **kw),
                          dname)
        keep = keep_mask(S, T, **kw, device="cuda")
        b_ms, b_by = bound(*fa_ops.flash_attention_work(q, k, **kw), dname)
        rows.append(dict(
            kernel="flash_attention", shape="qwen3-14b/ulysses16",
            case="train shard 15 of 16", dtype=dname, B=1, S=S, T=T, H=H,
            KVH=KVH, d=d, prefix_pad=off, prefix_len=off, max_abs_err=err,
            tol=TOL[dname], launch_key=dict(fa_ops.launch_key(q, k, **kw)),
            **flash_times(kw, keep, (q, k, v)), bound_ms=b_ms,
            bound_by=b_by))
    return rows


# the sequence shards of the train_tp_layouts phase's ulysses_sp cases:
# recurrentgemma-9b's last of three shards of 2304 positions, its 768
# query rows windowed back across the shard boundary, and one of three
# shards of whisper-medium's 1500 encoder frames over every frame
LAYOUT_FLASH = {
    "hybrid": dict(shape="recurrentgemma-9b/ulysses_sp3",
                   case="train shard 2 of 3, window 2048", B=1, S=768,
                   T=2304, H=16, KVH=1, d=256, causal=True, window=2048,
                   prefix_pad=1536, prefix_len=1536),
    "encoder": dict(shape="whisper-medium/ulysses_sp3",
                    case="train encoder shard of 3", B=4, S=500, T=1500,
                    H=16, KVH=16, d=64, causal=False),
}


def layout_flash_rows(gen):
    """Flash's two new forms at the train_tp_layouts phase's shards
    (:data:`LAYOUT_FLASH`) against their plain versions, in bf16 and f32,
    with the bound, the plain version's time and SDPA's with the same
    mask: the windowed prefix form (a prefix key kept only inside the
    window of the query's own position) and the encoder's non-causal
    shard (:func:`flash_row`)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)
    rows = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        h = dict(LAYOUT_FLASH["hybrid"])
        shape, case = h.pop("shape"), h.pop("case")
        B, S, T, H, KVH, d = (h.pop(n) for n in ("B", "S", "T", "H", "KVH",
                                                 "d"))
        q = torch.randn(B, S, H, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(B, T, KVH, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(B, T, KVH, d, generator=gen, device="cuda").to(dtype)
        label = f"flash {shape} {case} {dname}"
        out = fa_ops.flash_attention(q, k, v, **h)
        err = check_close(label, out, flash_attention_ref(q, k, v, **h),
                          dname)
        keep = keep_mask(S, T, **h, device="cuda")
        b_ms, b_by = bound(*fa_ops.flash_attention_work(q, k, **h), dname)
        rows.append(dict(
            kernel="flash_attention", shape=shape, case=case, dtype=dname,
            B=B, S=S, T=T, H=H, KVH=KVH, d=d, **h, max_abs_err=err,
            tol=TOL[dname], kv_rows=int(keep.any(0).sum().item()),
            launch_key=dict(fa_ops.launch_key(q, k, **h)),
            **flash_times(h, keep, (q, k, v)), bound_ms=b_ms, bound_by=b_by))
        e = dict(LAYOUT_FLASH["encoder"])
        rows.append(flash_row(gen, e.pop("shape"), e.pop("case"), dname,
                              **e))
    return rows


def gathered_grads(st_tree, grads):
    """{key: the global gradient} assembled from each coordinate's
    gradients of its slices (``mesh_loss_and_grads``), on the card."""
    from repro_torch.sharding.placement import ShardedTensor
    from repro_torch.training.tree import flatten
    out = {}
    for key, st in flatten(st_tree).items():
        shards = np.empty(st.mesh.devices.shape, dtype=object)
        for c in np.ndindex(shards.shape):
            shards[c] = grads[c][key]
        out[key] = ShardedTensor(st.sharding, st.shape, torch.float32,
                                 shards).full("cuda")
    return out


def train_tp_mesh(cfg, model, optimizer, shape, host_batch, seed, counters,
                  steps_n):
    """One mesh: the state placed, the loss and gradients of the first
    batch gathered to the host, then ``steps_n`` steps timed and counted.
    → (report, loss, gradients, launches, shapes by key)."""
    import gc

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import COLLECTIVES, data_rows

    t_mesh = time.perf_counter()
    n = int(np.prod(shape))
    mesh = Mesh(np.array(["cuda"] * n, dtype=object).reshape(shape),
                ("data", "model"))
    rls = R.make_rules(mesh, cfg)
    torch.cuda.reset_peak_memory_stats()
    state = steps.init_train_state(model, optimizer, seed, device="cuda")
    placed = steps.place_train_state(model, optimizer, state, mesh, rls)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    placement_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    batch = train_device_batch(cfg, host_batch)
    loss, _, g = steps.mesh_loss_and_grads(
        model, rls, placed["params"], steps.row_batches(rls, batch))
    grads = gathered_grads(placed["params"], g)
    del g
    dp, tp = len(data_rows(mesh)), shape[1]
    want = {"flash_attention": dp * tp * cfg.num_layers
            * (1 if cfg.remat == "none" else 2)}
    step_fn = steps.make_train_step(model, optimizer, mesh)
    step_s, losses = [], []
    zero_launches(counters)
    COLLECTIVES.reset()
    for i in range(steps_n):
        before = {k: c.launches for k, c in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed, metrics = step_fn(placed, batch)
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t0)
        check_launches(f"train_tp {cfg.name} {shape} step {i}", {
            k: c.launches - before[k] for k, c in counters.items()}, want)
        if i == 0:
            coll = COLLECTIVES.snapshot()
    launches, shapes = read_launches(counters)
    timed = sorted(step_s[1:]) or step_s
    rep = {"mesh": list(shape), "tp_strategy": rls.tp_strategy,
           "rows": dp, "shards": tp, "first_step_s": step_s[0],
           "step_median_s": statistics.median(timed),
           "step_p90_s": timed[int(0.9 * (len(timed) - 1))],
           "losses": losses, "flash_launches_per_step": want[
               "flash_attention"],
           "collectives_per_step": coll,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "placement_peak_memory_gb": placement_gb,
           "mesh_s": time.perf_counter() - t_mesh}
    del placed, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rep, loss.item(), grads, launches, shapes


def phase_train_tp(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.training.optimizer import AdamW

    counters = launch_counters()
    launches, shapes, out = {}, {}, []
    for case in (TRAIN_TP, TRAIN_TP_ULYSSES):
        full = get_config(case["arch"])
        by_dtype = {}
        for dname, layers, steps_n in (
                ("bfloat16", case["layers"], TRAIN_TP_STEPS),
                ("float32", TRAIN_TP_CHECK_LAYERS, 1)):
            cfg = full.replace(remat="full", microbatches=1, dtype=dname,
                               num_layers=layers)
            model = build_model(cfg)
            optimizer = AdamW(learning_rate=TRAIN_LR)
            host_batch = train_batch(cfg, case["batch"], case["seq"], 0,
                                     seed)
            base, reps = None, []
            for shape in case["meshes"]:
                rep, loss, grads, got, got_shapes = train_tp_mesh(
                    cfg, model, optimizer, shape, host_batch, seed,
                    counters, steps_n)
                if base is None:
                    base = (loss, grads)
                else:
                    errs = {k: rel_l2(grads[k], base[1][k]) for k in grads}
                    worst = max(errs, key=errs.get)
                    rep["loss_rel_err_vs_1x1"] = abs(loss - base[0]) \
                        / abs(base[0])
                    rep["worst_grad_rel_l2_vs_1x1"] = errs[worst]
                    rep["worst_leaf"] = worst
                    if dname == "float32" and not (
                            rep["loss_rel_err_vs_1x1"] <= TRAIN_TP_TOL_F32
                            and errs[worst] <= TRAIN_TP_TOL_F32):
                        fail(f"train_tp {cfg.name} f32 {shape}: loss "
                             f"{rep['loss_rel_err_vs_1x1']}, gradient "
                             f"{worst} {errs[worst]} against (1, 1) (tol "
                             f"{TRAIN_TP_TOL_F32})")
                del grads
                reps.append(rep)
                launches = {n: launches.get(n, 0) + got.get(n, 0)
                            for n in set(launches) | set(got)}
                shapes = add_shapes(shapes, got_shapes)
            by_dtype[dname] = {"layers": layers, "meshes": reps}
        if not all(math.isfinite(x) for r in by_dtype["bfloat16"]["meshes"]
                   for x in r["losses"]):
            fail(f"train_tp {full.name}: a loss is not finite")
        out.append({"model": full.name, "batch": case["batch"],
                    "seq": case["seq"],
                    "reduced": [f"num_layers {full.num_layers} -> "
                                f"{case['layers']} ({case['why']})"],
                    **by_dtype})
    emit({"phase": "train_tp", "card": card(), "coordinates_on_one_card":
          True, "remat": "full", "param_dtype": "float32", "lr": TRAIN_LR,
          "f32_tol": TRAIN_TP_TOL_F32, "cases": out})
    return launches, shapes


# phase 19: the sharded train step in every other layout the rules give,
# every coordinate on this card

# name → the model, its config changes, the mesh, the batch, the sequence
# and the float32 check's depth; ``timed``: also three bf16 steps at that
# depth against the (1, 1) mesh's ("grads": their forward and backward
# alone, where the mesh's placed train state would not fit one card)
TP_LAYOUTS = {
    # 16 heads over 3 shards: make_rules picks ulysses_sp; S = 2304 runs
    # past the 2048 window on shard 2.  Its train state placed on (1, 3)
    # takes 88.3 GB (the 256,000-row vocab tables, the RG-LRU and the
    # attention replicated on every shard), more than the card holds
    "hybrid_ulysses_sp": dict(arch="recurrentgemma-9b", mesh=(1, 3),
                              batch=1, seq=2304, depth=dict(num_layers=3),
                              timed="grads"),
    # S = 1020 splits three ways (1024 would run whole on every shard, the
    # fallback whisper's decoder takes): MoE routes the row's gathered
    # tokens, its capacity counted over all of them
    "moe_ulysses_sp": dict(arch="olmoe-1b-7b", mesh=(1, 3), batch=4,
                           seq=1020, depth=dict(num_layers=2), timed=True),
    # 1500 frames split three ways, the decoder's 448 positions do not:
    # every shard holds the whole decoder sequence
    "encdec_ulysses_sp": dict(arch="whisper-medium", mesh=(1, 3), batch=4,
                              seq=448, depth=dict(num_layers=2,
                                                  enc_layers=2),
                              timed=True),
    "dense_ulysses": dict(arch="stablelm-3b", rep=dict(tp_strategy="ulysses"),
                          mesh=(1, 2), batch=4, seq=1024,
                          depth=dict(num_layers=2)),
    "dense_heads_sp": dict(arch="stablelm-3b",
                           rep=dict(tp_strategy="heads_sp"), mesh=(1, 2),
                           batch=4, seq=1024, depth=dict(num_layers=2)),
    "dense_zero2": dict(arch="stablelm-3b", rep=dict(param_strategy="zero2"),
                        mesh=(2, 1), batch=4, seq=1024,
                        depth=dict(num_layers=2), timed=True),
    "dense_zero2_master": dict(arch="stablelm-3b",
                               rep=dict(param_strategy="zero2_master"),
                               mesh=(2, 2), batch=4, seq=1024,
                               depth=dict(num_layers=2)),
    # heads with what the model axis does not divide replicated: the
    # RG-LRU width, the SSD block, whisper's KV heads, and qwen3-14b's 40
    # q heads over 8 KV heads in unequal groups at 5 shards
    "hybrid_heads": dict(arch="recurrentgemma-9b",
                         rep=dict(tp_strategy="heads"), mesh=(1, 3),
                         batch=1, seq=2304, depth=dict(num_layers=3)),
    "ssm_heads": dict(arch="mamba2-2.7b", mesh=(1, 3), batch=4, seq=1024,
                      depth=dict(num_layers=2)),
    "encdec_heads": dict(arch="whisper-medium", rep=dict(tp_strategy="heads"),
                         mesh=(1, 3), batch=4, seq=448,
                         depth=dict(num_layers=2, enc_layers=2)),
    "gqa_heads": dict(arch="qwen3-14b", mesh=(1, 5), batch=1, seq=1024,
                      depth=dict(num_layers=2)),
}
TP_LAYOUT_STEPS = 3         # the first warms up and is not timed
# the ulysses_sp decode over a cache split by KV heads: qwen3-14b's 8 KV
# heads over 2 shards, a cache of 256 slots of which the step attends 101
TP_LAYOUT_DECODE = dict(arch="qwen3-14b", mesh=(1, 2), batch=4,
                        capacity=256, position=100, layers=2)


def layout_mesh(shape):
    from repro_torch.launch.mesh import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(["cuda"] * n, dtype=object).reshape(shape),
                ("data", "model"))


def layout_cfg(case, dname):
    from repro_torch.configs import get_config
    return get_config(case["arch"]).replace(
        remat="full", microbatches=1, dtype=dname, **case.get("rep", {}),
        **case["depth"])


def replicas_equal(label, st):
    """Every coordinate's local slice of ``st`` bit-equal to every other
    coordinate's copy of that slice; → the slices held more than once."""
    from repro_torch.sharding.placement import shard_slices
    first, shared = {}, set()
    for c in np.ndindex(st.mesh.devices.shape):
        key = tuple((s.start, s.stop) for s in shard_slices(
            st.shape, st.spec, st.mesh, c))
        if key in first:
            shared.add(key)
            if not torch.equal(st.local(c), first[key]):
                fail(f"{label}: coordinate {c}'s replica differs")
        else:
            first[key] = st.local(c)
    return len(shared)


def layout_f32_check(name, case, seed):
    """Float32 at the case's depth: the mesh's loss and every gradient
    leaf against the one-device step's under the same rules (relative L2
    within ``TRAIN_TP_TOL_F32``), every replica of a slice given the same
    gradient."""
    import gc

    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import named, place_tree

    cfg = layout_cfg(case, "float32")
    model = build_model(cfg)
    mesh = layout_mesh(case["mesh"])
    rls = R.make_rules(mesh, cfg)
    params = model.init(seed, device="cuda")
    batch = train_device_batch(cfg, train_batch(cfg, case["batch"],
                                                case["seq"], 0, seed))
    with R.use_rules(rls):
        loss1, _, g1 = steps.loss_and_grads(model, params, batch)
    ptree = place_tree(params, named(rls, R.params_pspecs(rls, model)))
    loss2, _, g2 = steps.mesh_loss_and_grads(
        model, rls, ptree, steps.row_batches(rls, batch))
    full = gathered_grads(ptree, g2)
    for key, st in steps.flatten(ptree).items():    # replicas: one gradient
        for c in np.ndindex(mesh.devices.shape):
            sl = shard_slices_of(st, c)
            if not torch.equal(g2[c][key], full[key][sl]):
                fail(f"train_tp_layouts {name}: {key}'s gradient at {c} "
                     f"differs from its replicas'")
    errs = {k: rel_l2(full[k], g1[k].float()) for k in full}
    worst = max(errs, key=errs.get)
    loss_err = abs(loss2.item() - loss1.item()) / abs(loss1.item())
    if not (loss_err <= TRAIN_TP_TOL_F32
            and errs[worst] <= TRAIN_TP_TOL_F32):
        fail(f"train_tp_layouts {name} f32: loss {loss_err}, gradient "
             f"{worst} {errs[worst]} against (1, 1) (tol "
             f"{TRAIN_TP_TOL_F32})")
    out = {"tp_strategy": rls.tp_strategy, "loss_rel_err_vs_1x1": loss_err,
           "worst_grad_rel_l2_vs_1x1": errs[worst], "worst_leaf": worst,
           "leaves": len(errs)}
    del params, ptree, g1, g2, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


def shard_slices_of(st, c):
    from repro_torch.sharding.placement import shard_slices
    return shard_slices(st.shape, st.spec, st.mesh, c)


def layout_flash_launches(cfg, rls):
    """Flash launches of one train step under ``rls`` at remat "full"
    (each attention twice): a row's attention sub-layer launches once a
    shard over sequence rows (split or whole), once a shard (a run of
    its q heads) over heads that split, else once, on shard 0."""
    from repro_torch.models import lm
    sizes = rls.mesh.shape
    tp = sizes.get("model", 1)
    dp = int(np.prod(rls.mesh.devices.shape)) // tp
    if cfg.family == "enc_dec":
        n_attn = cfg.enc_layers + 2 * cfg.num_layers
    else:
        n_attn = sum(k.startswith("attn") for k in lm.block_kinds(cfg))
    if lm.LAYOUTS[rls.tp_strategy][1]:
        per = tp
    elif cfg.num_heads % tp == 0:
        _, runs = lm.tp_kv_runs(cfg, tp, True, cfg.num_kv_heads % tp == 0)
        per = sum(len(r) if r else 1 for r in runs)
    else:
        per = 1
    return 2 * dp * per * n_attn


def layout_timed(name, case, seed, counters):
    """Three bf16 steps at the case's depth on (1, 1) and on the case's
    mesh (``timed="grads"``: each step's forward and backward alone,
    :func:`~repro_torch.launch.steps.mesh_loss_and_grads` over the
    placed parameters, replicas sharing one tensor): step times, flash launches a step held to
    :func:`layout_flash_launches`, the collectives by kind and the peak
    memory of the mesh's steps; after them every slice held more than
    once bit-equal across its holders, in the parameters and the
    optimizer state (the gradients, without the optimizer)."""
    import gc

    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.placement import (
        COLLECTIVES, ShardedTensor, named, place_tree)
    from repro_torch.training.optimizer import AdamW

    cfg = layout_cfg(case, "bfloat16")
    model = build_model(cfg)
    optimizer = AdamW(learning_rate=TRAIN_LR,
                      master_weights=cfg.param_strategy == "zero2_master")
    grads_only = case["timed"] == "grads"
    host = train_batch(cfg, case["batch"], case["seq"], 0, seed)
    out = {}
    for shape in ((1, 1), case["mesh"]):
        mesh = layout_mesh(shape)
        rls = R.make_rules(mesh, cfg)
        if grads_only:     # replicas share their storage: nothing updates
            params = model.init(seed, device="cuda")
            placed = {"params": place_tree(params, named(
                rls, R.params_pspecs(rls, model)))}
            del params

            def step_fn(placed, batch, rls=rls, mesh=mesh):
                loss, _, g = steps.mesh_loss_and_grads(
                    model, rls, placed["params"],
                    steps.row_batches(rls, batch))
                # each coordinate's gradients in its layout, checked
                # here: a step's gradients are not kept past it
                shared = 0
                for k, st in steps.flatten(placed["params"]).items():
                    shards = np.empty(mesh.devices.shape, dtype=object)
                    for c in np.ndindex(shards.shape):
                        shards[c] = g[c][k]
                    shared += replicas_equal(
                        f"train_tp_layouts {name} {shape} grad {k}",
                        ShardedTensor(st.sharding, st.shape, torch.float32,
                                      shards))
                placed["grad_slices_shared"] = shared
                return placed, {"loss": loss}
        else:
            state = steps.init_train_state(model, optimizer, seed,
                                           device="cuda")
            placed = steps.place_train_state(model, optimizer, state, mesh,
                                             rls)
            del state
            step_fn = steps.make_train_step(model, optimizer, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch = train_device_batch(cfg, host)
        want = {"flash_attention": layout_flash_launches(cfg, rls)}
        times, losses = [], []
        for i in range(TP_LAYOUT_STEPS):
            before = {k: c.launches for k, c in counters.items()}
            COLLECTIVES.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            placed, metrics = step_fn(placed, batch)
            losses.append(metrics["loss"].item())
            times.append(time.perf_counter() - t0)
            got = {k: c.launches - before[k] for k, c in counters.items()}
            if got["flash_attention"] != want["flash_attention"] or (
                    cfg.family == "hybrid" and not got["rglru_scan"]):
                fail(f"train_tp_layouts {name} {shape} step {i}: launches "
                     f"{got}, flash {want['flash_attention']}")
        coll = COLLECTIVES.snapshot()
        trees = [placed["params"]] + ([] if grads_only else [placed["opt"]])
        shared = sum(replicas_equal(f"train_tp_layouts {name} {shape} {k}",
                                    st) for tree in trees
                     for k, st in steps.flatten(tree).items())
        shared += placed.get("grad_slices_shared", 0)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train_tp_layouts {name} {shape}: a loss is not finite")
        out["x".join(map(str, shape))] = {
            "tp_strategy": rls.tp_strategy, "step": "forward and backward"
                if grads_only else "train step", "step_median_s":
                statistics.median(times[1:]), "first_step_s": times[0],
                "losses": losses, "flash_launches_per_step":
                want["flash_attention"], "collectives_per_step": coll,
                "replicated_slices_bit_equal": shared,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del placed, batch, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    one, mesh_rep = out["1x1"], out["x".join(map(str, case["mesh"]))]
    mesh_rep["step_vs_1x1"] = mesh_rep["step_median_s"] \
        / one["step_median_s"]
    return out


def layout_decode_check(seed):
    """qwen3-14b under ulysses_sp at (1, 2), float32, one decode step of
    the dry-run's decode step over a cache the rules split by KV heads
    (random K/V in every slot up to the step's position) against the
    one-device ``decode_step`` on a copy of the same cache: logits within
    ``TRAIN_TP_TOL_F32`` (relative L2), decode-attention launches one a
    shard a layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters
    from repro_torch.sharding import rules as R

    d = TP_LAYOUT_DECODE
    cfg = get_config(d["arch"]).replace(
        tp_strategy="ulysses_sp", dtype="float32", num_layers=d["layers"])
    model = build_model(cfg)
    rls = R.make_rules(layout_mesh(d["mesh"]), cfg)
    params = model.init(seed, device="cuda")
    B, C, pos = d["batch"], d["capacity"], d["position"]
    cache = model.init_cache(B, C, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for leaf in steps.flatten(cache).values():
        leaf[..., :pos, :, :] = torch.randn(
            leaf[..., :pos, :, :].shape, generator=gen, device="cuda")
    placed = steps.place_cache(rls, cache)
    tokens = torch.randint(1, cfg.vocab_size, (B, 1), generator=gen,
                           device="cuda", dtype=torch.int32)
    positions = torch.full((B,), pos, dtype=torch.int32, device="cuda")
    want = model.decode_step(params, cache, tokens, positions)[0]
    counters = launch_counters()
    zero_launches(counters)
    got = steps.make_decode_step(model, rls, C)(
        steps.place_params(model, rls, params), placed, tokens,
        positions)[0]
    launches = read_launches(counters)[0]
    # the real vocab: the padding's -1e30 would swamp any difference
    err = rel_l2(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size])
    shards = d["mesh"][1]
    if err > TRAIN_TP_TOL_F32 or launches["decode_attention"] \
            != shards * cfg.num_layers:
        fail(f"train_tp_layouts ulysses_sp decode: logits {err} (tol "
             f"{TRAIN_TP_TOL_F32}), launches {launches}")
    specs = R.cache_pspecs(rls, cache)
    return {"model": cfg.name, "tp_strategy": rls.tp_strategy,
            "mesh": list(d["mesh"]), "layers": cfg.num_layers, "batch": B,
            "capacity": C, "position": pos,
            "cache_k_spec": list(steps.flatten(specs)["layers/b0/k"]),
            "logits_rel_l2_vs_1x1": err,
            "decode_attention_launches": launches["decode_attention"]}


def phase_train_tp_layouts(seed):
    from repro_torch.configs import get_config
    from repro_torch.serving.decode_graph import launch_counters

    counters = launch_counters()
    out = []
    t_main = 0.0
    launches, shapes = {}, {}
    for name, case in TP_LAYOUTS.items():
        t0 = time.perf_counter()
        full = get_config(case["arch"])
        rep = {"model": full.name, "mesh": list(case["mesh"]),
               "config": case.get("rep", {}), "batch": case["batch"],
               "seq": case["seq"],
               "reduced": [f"{k} {getattr(full, k)} -> {v} (the phase's "
                           f"time and one card's memory: the (1, 1) "
                           f"state beside the mesh's)"
                           for k, v in case["depth"].items()
                           if getattr(full, k) != v],
               "float32": layout_f32_check(name, case, seed)}
        emit({"phase": "train_tp_layouts", "case": name,
              "float32": rep["float32"]})
        if case.get("timed"):
            t1 = time.perf_counter()
            zero_launches(counters)
            rep["bfloat16"] = layout_timed(name, case, seed, counters)
            got, got_shapes = read_launches(counters)
            launches = {n: launches.get(n, 0) + got.get(n, 0)
                        for n in set(launches) | set(got)}
            shapes = add_shapes(shapes, got_shapes)
            t_main += time.perf_counter() - t1
        rep["case_s"] = time.perf_counter() - t0
        out.append(rep)
        emit({"phase": "train_tp_layouts", "case": name, **rep})
    decode = layout_decode_check(seed)
    emit({"phase": "train_tp_layouts", "card": card(),
          "coordinates_on_one_card": True, "remat": "full",
          "param_dtype": "float32", "lr": TRAIN_LR,
          "f32_tol": TRAIN_TP_TOL_F32, "timed_s": t_main,
          "cases": {c["model"] + " " + n: {
              "mesh": c["mesh"], "tp_strategy": c["float32"]["tp_strategy"],
              "loss_rel_err_vs_1x1": c["float32"]["loss_rel_err_vs_1x1"],
              "worst_grad_rel_l2_vs_1x1":
                  c["float32"]["worst_grad_rel_l2_vs_1x1"],
              **({"step_vs_1x1": c["bfloat16"]["x".join(
                  map(str, c["mesh"]))]["step_vs_1x1"]}
                 if "bfloat16" in c else {})}
              for n, c in zip(TP_LAYOUTS, out)},
          "ulysses_sp_decode": decode})
    return launches, shapes


# phase 20: compound-AI programs on the port's own PopPy core, driving the
# paged engine through the port's dispatcher and backend
POPPY_DOCS = 8                 # program A's fan-out
POPPY_AGENTS = 5               # program B's debaters
POPPY_ROUNDS = 2               # B's rounds after the opening one
POPPY_QUESTION = "what is the boiling point of water at sea level?"
POPPY_PERSONAS = ("scientist", "historian", "engineer", "economist", "critic")
# the held comparison runs each mode on a fresh engine with the prefix
# cache off: a prefill over a reused prefix rounds bf16 otherwise than a
# whole one, and the decode step runs all slots at fixed shapes, so a
# request's tokens do not depend on what else is in the batch
POPPY_ENGINE = {**SERVE_ENGINE, "prefix_cache_budget": 0}
# the combine prompt's length bound: the engine's 1024 positions hold it
# and its 12 new tokens whatever the summaries decode to
POPPY_COMBINE_CHARS = 480
# each engine's untimed first request (2 new tokens: one decode step)
POPPY_WARM_UP = [256, 1, 2, 3]


def text_checksum(text):
    """A pure-Python, CPU-bound function for program C's
    ``offload="process"`` external (module level: the worker imports it
    by name)."""
    h = 0
    for ch in text:
        h = (h * 131 + ord(ch)) % 1_000_000_007
    return h


def poppy_programs():
    """Programs A, B and C, written against the port's own ``@poppy`` as
    ``examples/serve_llm.py`` and ``examples/multi_agent_debate.py`` write
    them.  → a namespace with the programs, the ``report`` lines (in
    program order) and the debate's ``MemoryStore``."""
    from repro_torch.core import poppy, sequential, unordered
    from repro_torch.core.ai import MemoryStore, llm, llm_sync

    lines = []
    memory = MemoryStore("debate")
    checksum = unordered(offload="process",
                         returns_immutable=True)(text_checksum)

    @sequential
    def report(line):
        lines.append(line)
        return None

    # A: independent summaries, each reported in order, then one combine
    @poppy
    def summarize_documents(n_docs):
        summaries = tuple()
        for i in range(n_docs):
            s = llm(f"summarize document {i}", max_tokens=32)
            report(f"doc {i}: {s}")
            summaries += (s,)
        overall = llm(f"combine: {summaries}"[:POPPY_COMBINE_CHARS],
                      max_tokens=12)
        report(f"combined: {overall}")
        return overall

    # B: the debate, each agent's positions in its own memory domain
    @poppy
    def agent_turn(agent, persona, question, others):
        position = llm(f"as a {persona}, answer briefly: {question} | "
                       f"others said: {others}", max_tokens=12)
        memory.append(agent, position)
        words = position.split()
        return words[0] if words else "unknown"

    @poppy
    def debate(question):
        answers = ()
        for i in range(POPPY_AGENTS):
            a = agent_turn(f"agent{i}", POPPY_PERSONAS[i], question, "")
            answers += (a,)
        for rnd in range(POPPY_ROUNDS):
            revised = ()
            for i in range(POPPY_AGENTS):
                others = answers[:i] + answers[i + 1:]
                a = agent_turn(f"agent{i}", POPPY_PERSONAS[i], question,
                               f"{others}")
                revised += (a,)
            answers = revised
        counts = {}
        for a in answers:
            counts[a] = counts.get(a, 0) + 1
        best = None
        best_n = 0
        for a, n in sorted(counts.items()):
            if n > best_n:
                best, best_n = a, n
        return (best, best_n, len(counts))

    # C: A with the blocking client (offloaded to the runtime's threads)
    # and one pure-Python external in a worker process
    @poppy
    def summarize_documents_sync(n_docs):
        summaries = tuple()
        for i in range(n_docs):
            s = llm_sync(f"summarize document {i}", max_tokens=32)
            report(f"doc {i}: {s}")
            summaries += (s,)
        prompt = f"combine: {summaries}"[:POPPY_COMBINE_CHARS]
        overall = llm_sync(prompt, max_tokens=12)
        report(f"combined: {overall}")
        return (overall, prompt, checksum(prompt))

    return types.SimpleNamespace(
        A=summarize_documents, B=debate, C=summarize_documents_sync,
        lines=lines, memory=memory)


def record_calls(engine):
    """Wrap ``engine.generate`` to record each request's (prompt tokens,
    greedy tokens); → the list it appends to."""
    calls = []
    real = engine.generate

    async def generate(prompt_tokens, **kw):
        out = await real(prompt_tokens, **kw)
        calls.append((tuple(prompt_tokens), tuple(out)))
        return out
    engine.generate = generate
    return calls


def externals_idle_s(trace, wall_s):
    """Seconds of a run's wall time in which no external call of its trace
    was in flight: the runtime's own time outside external calls (and
    the host's between them)."""
    spans = sorted((e.t_dispatch, e.t_resolve) for e in trace.events
                   if e.seq_no >= 0 and e.t_resolve >= e.t_dispatch)
    covered, end = 0.0, -math.inf
    for a, b in spans:
        if b <= end:
            continue
        covered += b - max(a, end)
        end = b
    return max(wall_s - covered, 0.0)


def poppy_run(label, model, params, programs, name, arg, counters, *,
              sequential=False, sync=False, batch=False, engine_kw=None):
    """Program ``name`` of ``programs`` once, on a fresh engine behind a
    port ``Dispatcher`` (admission at the engine's slots) and a port
    ``LocalEngineBackend``: under standard Python (``sequential``) or
    PopPy, with the blocking clients (``sync``: thread offload, one
    worker process) or with queue-time batching (``batch``).  An untimed
    request first runs the engine's eager first decode step and its
    graph capture, on the loop the program's requests will use.  Holds
    paged decode launched once a layer a decode step and flash once a
    layer a prefill chunk over the run, every launch count set to 0 just
    before it, and the decode graph.  → the run's record."""
    import contextlib

    from repro_torch.core import (batching, offload_policy, recording,
                                  sequential_mode)
    from repro_torch.core.ai import (run_blocking, use_dispatcher,
                                     use_sync_clients)
    from repro_torch.dispatch import AdmissionPolicy, Dispatcher
    from repro_torch.serving.backend import LocalEngineBackend
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(model, params, **(engine_kw or POPPY_ENGINE))

    async def warm_up():
        await engine.generate(POPPY_WARM_UP, max_new_tokens=2)
    if sync:
        run_blocking(warm_up)
    else:
        asyncio.run(warm_up())
    steps0, chunks0 = engine.steps, engine.prefill_chunks
    occ0 = len(engine.batch_occupancy)
    calls = record_calls(engine)
    dispatcher = Dispatcher([LocalEngineBackend(engine)],
                            admission=AdmissionPolicy(
                                max_concurrency=engine.max_slots))
    programs.lines.clear()
    programs.memory.clear()
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(use_dispatcher(dispatcher))
        trace = ctx.enter_context(recording())
        if sequential:
            ctx.enter_context(sequential_mode())
        if sync:
            ctx.enter_context(use_sync_clients())
            ctx.enter_context(offload_policy(mode="thread",
                                             process_workers=1))
        if batch:
            ctx.enter_context(batching())
        zero_launches(counters)
        t0 = time.perf_counter()
        result = getattr(programs, name)(arg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches, shapes = read_launches(counters)
    if sync:
        # the blocking clients ran the engine on the bridge loop's thread
        run_blocking(engine.stop)
    st = engine.stats()
    steps, chunks = st["steps"] - steps0, st["prefill_chunks"] - chunks0
    L = model.cfg.num_layers
    check_launches(label, {n: launches[n] for n in ("paged_decode_attention",
                                                     "flash_attention")},
                   {"paged_decode_attention": L * steps,
                    "flash_attention": L * chunks})
    graph = check_graph(label, st["decode_graph"], st["steps"],
                        {"paged_decode_attention": L})
    occ = engine.batch_occupancy[occ0:]
    dec = sorted(engine.decode_step_s[occ0:])
    return {"label": label, "engine": engine, "result": result,
            "lines": list(programs.lines),
            "memory": programs.memory.snapshot(), "trace": trace,
            "calls": sorted(calls), "wall_s": wall_s,
            # standard Python records each call at its start, with no
            # duration: the measure reads PopPy runs only
            "outside_externals_s": None if sequential
            else externals_idle_s(trace, wall_s),
            "decode_steps": steps, "prefill_chunks": chunks,
            "max_occupancy": max(occ, default=0),
            "mean_occupancy": sum(occ) / max(len(occ), 1),
            "decode_s": sum(dec),
            "decode_step_median_ms": statistics.median(dec) * 1e3,
            "launches": {n: k for n, k in launches.items() if k},
            "shapes": shapes, "graph": graph,
            "prefix": dispatcher.stats.snapshot()["prefix"]}


def hold_modes(label, seq, pop, fan_out):
    """Standard Python against PopPy on one program: equal results,
    ``report`` lines, memories and greedy tokens call for call, ≡_A
    traces, and the decode batches' maximum occupancy 1 against the
    program's fan-out."""
    from repro_torch.core import equivalent

    for key in ("result", "lines", "memory", "calls"):
        if seq[key] != pop[key]:
            fail(f"poppy_apps {label}: {key} differ between standard "
                 f"Python and PopPy: {seq[key]!r} vs {pop[key]!r}")
    ok, why = equivalent(seq["trace"], pop["trace"])
    if not ok:
        fail(f"poppy_apps {label}: traces not equivalent: {why}")
    if seq["max_occupancy"] != 1 or pop["max_occupancy"] != fan_out:
        fail(f"poppy_apps {label}: maximum decode occupancy "
             f"{seq['max_occupancy']} (standard Python) and "
             f"{pop['max_occupancy']} (PopPy); want 1 and {fan_out}")


def run_record(r):
    """What a run prints."""
    return {k: r[k] for k in ("wall_s", "outside_externals_s",
                              "decode_steps", "prefill_chunks",
                              "max_occupancy", "mean_occupancy",
                              "decode_s", "decode_step_median_ms",
                              "launches", "graph")}


def poppy_observed(model, params, programs, counters):
    """Program A under PopPy twice more, on a fresh engine after an
    unprofiled run has built its decode graph: once under
    ``repro_torch.obs.tracing()``, whose one tracer records the runtime's
    spans and the engine's (held: an ``llm`` and a ``request`` span a
    call, a ``decode.step`` span a decode step), with the critical-path
    report (:func:`trace_report`); once under ``torch.profiler``, for the
    device's busy share (:func:`profile_report`).  → (trace, profile)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.core.ai import use_dispatcher
    from repro_torch.dispatch import Dispatcher
    from repro_torch.serving.backend import LocalEngineBackend

    engine = poppy_run("poppy_apps A observed", model, params, programs,
                       "A", POPPY_DOCS, counters)["engine"]
    dispatcher = Dispatcher([LocalEngineBackend(engine)])
    steps0 = engine.steps
    with use_dispatcher(dispatcher), obs.tracing() as trz:
        t0 = time.perf_counter()
        programs.A(POPPY_DOCS)
        seconds = time.perf_counter() - t0
    counts = Counter(sp.name for sp in trz.spans + trz.instants)
    steps = engine.steps - steps0
    # one tracer holds the runtime's spans and the engine's
    want = {"llm": POPPY_DOCS + 1, "request": POPPY_DOCS + 1,
            "decode.step": steps}
    if {n: counts[n] for n in want} != want:
        fail(f"poppy_apps traced A: spans {dict(counts)}, want {want}")
    traced = {"seconds": seconds, "decode_steps": steps,
              "spans": dict(sorted(counts.items())),
              "report": trace_report(trz, "poppy_apps_trace_report.txt")}
    with use_dispatcher(dispatcher):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            programs.A(POPPY_DOCS)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return traced, profile_report(prof, wall_us, "poppy_apps_profile.txt")


def phase_poppy_apps(seed):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.decode_graph import launch_counters

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    counters = launch_counters()
    programs = poppy_programs()
    launches, shapes = collections.Counter(), {}

    def run(label, name, arg, **kw):
        nonlocal shapes
        r = poppy_run(f"poppy_apps {label}", model, params, programs, name,
                      arg, counters, **kw)
        del r["engine"]
        launches.update(r["launches"])
        shapes = add_shapes(shapes, r.pop("shapes"))
        return r

    a_seq = run("A standard", "A", POPPY_DOCS, sequential=True)
    a_pop = run("A poppy", "A", POPPY_DOCS)
    hold_modes("A", a_seq, a_pop, POPPY_DOCS)
    b_seq = run("B standard", "B", POPPY_QUESTION, sequential=True)
    b_pop = run("B poppy", "B", POPPY_QUESTION)
    hold_modes("B", b_seq, b_pop, POPPY_AGENTS)

    c_pop = run("C poppy", "C", POPPY_DOCS, sync=True)
    overall, prompt, digest = c_pop["result"]
    if overall != a_pop["result"] or c_pop["calls"] != a_pop["calls"] \
            or c_pop["lines"] != a_pop["lines"]:
        fail(f"poppy_apps C: result, tokens or report lines differ from "
             f"A's PopPy run: {c_pop['result']!r} vs {a_pop['result']!r}")
    if digest != text_checksum(prompt):
        fail(f"poppy_apps C: the process-offloaded external gave {digest}, "
             f"the plain call {text_checksum(prompt)}")

    cached = run("A batched", "A", POPPY_DOCS, batch=True,
                 engine_kw=SERVE_ENGINE)
    prefix = cached["prefix"] or {}
    if not prefix.get("batches", 0) > 0 \
            or not prefix.get("shared_tokens", 0) > 0:
        fail(f"poppy_apps A batched: the backend's shared-prefix counts "
             f"{prefix} did not grow: the warm path did not run")

    traced, profiled = poppy_observed(model, params, programs, counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "poppy_apps", "card": card(), "model": cfg.name,
          "layers": cfg.num_layers, "dtype": "bfloat16",
          "engine": {k: v for k, v in POPPY_ENGINE.items() if k != "device"},
          "A": {"calls": POPPY_DOCS + 1,
                "standard": run_record(a_seq), "poppy": run_record(a_pop),
                "speedup": a_seq["wall_s"] / a_pop["wall_s"]},
          "B": {"calls": POPPY_AGENTS * (1 + POPPY_ROUNDS),
                "standard": run_record(b_seq), "poppy": run_record(b_pop),
                "speedup": b_seq["wall_s"] / b_pop["wall_s"]},
          "C": {"poppy": run_record(c_pop),
                "vs_A_poppy": c_pop["wall_s"] / a_pop["wall_s"],
                "process_checksum": digest},
          "A_batched_prefix_cache": {
              **run_record(cached), "prefix_batches": prefix,
              "result_equal": cached["result"] == a_pop["result"],
              "tokens_equal": cached["calls"] == a_pop["calls"]},
          "traced_A_poppy": traced, "profiled_A_poppy": profiled,
          "peak_memory_gb": peak_gb})
    return dict(launches), shapes


def summary_row(r, shapes):
    """One kernels-phase row in the summary line: what tells it apart, its
    times, bound, error and the launches the main paths made at its launch
    key (``shapes``: {kernel: Counter by launch key}, as counted)."""
    key = tuple(r["launch_key"].items())
    return {**{k: r[k] for k in ROW_KEYS if k in r},
            **{k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "max_abs_err")},
            "main_path_launches": shapes.get(r["kernel"], {}).get(key, 0)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kernel_rows, launches, seconds = [], {}, {}
    shapes = {}        # {phase: {kernel: Counter of launches by key}}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        kernel_rows = timed("kernels", phase_kernels)
    if "serve" in phases:
        launches, shapes["serve"] = timed("serve", phase_serve, args.seed)
    runners = {"serve_tp": phase_serve_tp,
               "serve_tp_families": phase_serve_tp_families,
               "serve_tp_fallbacks": phase_serve_tp_fallbacks,
               "ef_allreduce": phase_ef_allreduce,
               "serve_hybrid": phase_serve_hybrid,
               "serve_ssm": phase_serve_ssm,
               "serve_moe": phase_serve_moe,
               "encdec": phase_encdec,
               "serve_vlm": phase_serve_vlm,
               "serve_fleet": phase_serve_fleet,
               "train_tp": phase_train_tp,
               "train_tp_layouts": phase_train_tp_layouts,
               "poppy_apps": phase_poppy_apps,
               **{name: functools.partial(phase_train, name)
                  for name in TRAIN_CASES}}
    for name in PHASES:
        fn = runners.get(name)
        if fn is not None and name in phases:
            more, shapes[name] = timed(name, fn, args.seed)
            launches = {n: launches.get(n, 0) + more.get(n, 0)
                        for n in set(launches) | set(more)}
    emit({"phase": "timing", "seconds": seconds})
    emit({"phase": "launches_by_shape",
          **{name: shape_table(s) for name, s in shapes.items()}})
    main_shapes = {}
    for s in shapes.values():
        main_shapes = add_shapes(main_shapes, s)

    summary = []
    for name, case in SUMMARY_CASE.items():
        rows = [r for r in kernel_rows if r["kernel"] == name
                and all(r.get(k) == v for k, v in case.items())]
        if not rows:
            continue
        r = rows[0]
        summary.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "rows": [summary_row(r, main_shapes)
                                 for r in kernel_rows
                                 if r["kernel"] == name]})
    print(json.dumps({"kernels": summary}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
