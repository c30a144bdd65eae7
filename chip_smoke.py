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
             and cross memory (C = 1500, every slot valid).
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
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PHASES = ("build", "kernels", "serve", "serve_hybrid", "serve_ssm",
          "serve_moe", "encdec", "serve_vlm")

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
    device time, the most first."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
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
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    check_flash_tile_plan()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = {"stablelm-3b": dict(H=32, KVH=32, d=80),
              "gqa-40:8": dict(H=40, KVH=8, d=128),
              "olmoe-1b-7b": dict(H=16, KVH=16, d=128),
              "pixtral-12b": dict(H=32, KVH=8, d=160)}
    B, ps, N = 8, 16, 64
    lengths = [1024, 777, 512, 300, 129, 64, 1, 600]   # last: retired slot
    results = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        es = torch.finfo(dtype).bits // 8
        for sname, sh in shapes.items():
            H, KVH, d = sh["H"], sh["KVH"], sh["d"]
            # -- paged decode
            q, kp, vp, table, lens = paged_case(
                gen, B=B, ps=ps, N=N, dtype=dtype, lengths=lengths,
                **sh)
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

            cases = check_paged_cases(gen, sname, sh, dname, dtype, out,
                                      args)
            toks = sum(min(x, N * ps) for x in lengths)
            rows = int(paged_kv_keys(table, lengths, ps).size)
            nbytes = 2 * q.numel() * es + 2 * rows * KVH * d * es \
                + table.numel() * 4 + lens.numel() * 4
            flops = 4 * toks * H * d
            b_ms, b_by = bound(nbytes, flops, dname)
            results.append(dict(
                kernel="paged_decode_attention", shape=sname, dtype=dname,
                B=B, H=H, KVH=KVH, d=d, ps=ps, lengths=lengths,
                launch_key=dict(pa_ops.launch_key(q, kp, table)),
                kv_rows=rows, max_abs_err=err, tol=TOL[dname],
                **kernel_times(pa_ops.paged_decode_attention,
                               paged_decode_attention_ref, sdpa_paged, args),
                bound_ms=b_ms, bound_by=b_by, chunk=pa_ops.CHUNK,
                nan_unread_bit_equal=True,
                more_cases=cases))
            emit({"phase": "kernels", **results[-1]})

            # -- flash, exact causal and with a padded prefix: ragged, and
            #    with no valid row
            S = 256
            for pad, plen in ((0, 0), (512, 384), (512, 0)):
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
                pairs = int(keep.sum().item())
                # K/V rows some query keeps: prefix padding is never read
                rows = int(keep.any(0).sum().item())
                nbytes = (2 * q.numel() + 2 * rows * KVH * d) * es
                flops = 4 * pairs * H * d
                b_ms, b_by = bound(nbytes, flops, dname)
                results.append(dict(
                    kernel="flash_attention", shape=sname, dtype=dname,
                    S=S, T=T, H=H, KVH=KVH, d=d, prefix_pad=pad,
                    prefix_len=plen, kv_rows=rows, max_abs_err=err,
                    launch_key=dict(fa_ops.launch_key(q, k, **kw)),
                    tol=TOL[dname], **flash_times(kw, keep, (q, k, v)),
                    bound_ms=b_ms, bound_by=b_by))
                emit({"phase": "kernels", **results[-1]})
    for row in (hybrid_kernel_rows(gen) + ssd_kernel_rows(gen)
                + encdec_kernel_rows(gen)):
        results.append(row)
        emit({"phase": "kernels", **row})
    return results


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
    es = torch.finfo(dtype).bits // 8
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
        kv_es = es
    else:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        args = (q, k8, v8, ks, vs, valid)
        fn = da_ops.decode_attention_int8
        ref_fn = decode_attention_int8_ref
        kv_es = 1 + 4 / d                     # int8 + one f32 scale
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

    nbytes = 2 * q.numel() * es + 2 * n_valid * KVH * d * kv_es \
        + valid.numel()
    flops = 4 * n_valid * H * d
    b_ms, b_by = bound(nbytes, flops, dname)
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
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref

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
        es = torch.finfo(dtype).bits // 8
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
        pairs = int(keep.sum().item())
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es,
                           4 * pairs * H * d, dname)
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
    Wd = 4096
    for B, S, with_h0 in ((1, 2100, False), (1, 2100, True), (1, 37, True),
                          (1, 1, False), (2, 2100, True)):
        a = torch.sigmoid(torch.randn(B, S, Wd, generator=gen, device=dev))
        b = torch.randn(B, S, Wd, generator=gen, device=dev)
        h = torch.randn(B, Wd, generator=gen, device=dev) \
            if with_h0 else None
        out = lru_ops.rglru_scan(a, b, h)
        err = check_close(f"rglru_scan B={B} S={S} h0={with_h0}", out,
                          rglru_scan_ref(a, b, h), "float32")
        # one entry per read of a and b and per write of h; 2 flops each
        b_ms, b_by = bound(3 * a.numel() * 4 + (B * Wd * 4 if with_h0 else 0),
                           2 * a.numel(), "float32")
        rows.append(dict(
            kernel="rglru_scan", shape="recurrentgemma-9b", dtype="float32",
            B=B, S=S, W=Wd, h0=with_h0, max_abs_err=err, tol=TOL["float32"],
            launch_key=dict(lru_ops.launch_key(a, h)),
            **kernel_times(lru_ops.rglru_scan, rglru_scan_ref, None,
                           (a, b, h)),
            library_note="no single PyTorch call computes a linear "
                         "recurrence with per-step coefficients",
            bound_ms=b_ms, bound_by=b_by))
    return rows


def ssd_kernel_rows(gen):
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
    H, P, N, chunk = 80, 64, 128, 256
    rows = []
    for S, with_h0, decay in ((2048, False, "init"), (2048, True, "init"),
                              (2100, False, "init"), (120, False, "init"),
                              (2, False, "init"), (2048, False, "strong")):
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
        nbytes = 4 * (2 * S * H * P + S * H + H + 2 * S * N
                      + H * P * N * (2 if with_h0 else 1))
        flops = ssd_needed_flops((dt * -torch.exp(a_log))[0], with_h0, N, P)
        b_ms, b_by = bound(nbytes, flops, "float32")
        rows.append(dict(
            kernel="ssd_chunk_scan", shape="mamba2-2.7b", dtype="float32",
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
            if S == 2048 and decay == "init" else None,
            bound_ms=b_ms, bound_by=b_by))
    return rows


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)

    w = WHISPER_ATTN
    B, H, d, T = w["B"], w["H"], w["d"], w["T"]
    P = ENCDEC_PROMPT
    rows = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        es = torch.finfo(dtype).bits // 8
        for case, S, Tk, causal in (("encoder", T, T, False),
                                    ("prefill cross", P, T, False),
                                    ("decoder self", P, P, True)):
            q = torch.randn(B, S, H, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(B, Tk, H, d, generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(B, Tk, H, d, generator=gen,
                            device="cuda").to(dtype)
            kw = dict(causal=causal)
            label = f"flash whisper-medium {case} {dname}"
            out = fa_ops.flash_attention(q, k, v, **kw)
            err = check_close(label, out, flash_attention_ref(q, k, v, **kw),
                              dname)
            check_flash_tail_nan(label, q, k, v, kw, out)
            keep = keep_mask(S, Tk, device="cuda") if causal else None
            pairs = int(keep.sum().item()) if causal else S * Tk
            b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es,
                               4 * B * H * pairs * d, dname)
            rows.append(dict(
                kernel="flash_attention", shape="whisper-medium", case=case,
                dtype=dname, B=B, S=S, T=Tk, H=H, KVH=H, d=d, causal=causal,
                prefix_pad=0, prefix_len=0, max_abs_err=err, tol=TOL[dname],
                launch_key=dict(fa_ops.launch_key(q, k, **kw)),
                **flash_times(kw, keep, (q, k, v)), bound_ms=b_ms,
                bound_by=b_by))
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


def check_paged_serve(label, cfg, st, outs, launches):
    """A paged engine's first warm-prefix fan-out: 32 in-vocab tokens a
    request, the prefix reused, no KV copied at admission, one paged
    decode launch per layer per decode step and one flash launch per
    layer per prefill chunk, and the decode graph (:func:`check_graph`).
    → the graph's stats."""
    L = cfg.num_layers
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
            eager, _ = engine.model.decode_step(engine.params, *clone)
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
    """Every launch count to 0, in all and by launch key."""
    for fn in counters.values():
        fn.launches = 0
        fn.shapes.clear()


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
                                              pos)
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


# the fields that tell a kernel's rows apart, in the summary line
ROW_KEYS = ("shape", "case", "dtype", "B", "S", "T", "C", "prefix_pad",
            "prefix_len", "window", "h0", "decay")


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
    for name, fn in (("serve_hybrid", phase_serve_hybrid),
                     ("serve_ssm", phase_serve_ssm),
                     ("serve_moe", phase_serve_moe),
                     ("encdec", phase_encdec),
                     ("serve_vlm", phase_serve_vlm)):
        if name in phases:
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
