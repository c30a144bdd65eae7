#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

1. build   — compile every CUDA kernel of the port from the sources in
             this checkout (``src/repro_torch/kernels/*/csrc/*.cu``).
2. kernels — each kernel against its plain PyTorch version on the card,
             at the main path's shapes (stablelm-3b and a GQA shape), in
             bf16 (tolerance 2e-2) and f32 (2e-5), with its median time
             over CUDA events, its bound, the plain version's time and a
             PyTorch library call's time as a yardstick the port never
             calls.
3. serve   — full-width stablelm-3b (32 layers, bf16, random weights from
             a seeded generator on the card) behind the port's paged
             ServingEngine: a warmed 384-token shared prefix, then 8
             concurrent greedy requests.  Checks the outputs, that the
             path launched each kernel exactly once per layer per decode
             step / prefill chunk, and one prefill's and one decode
             step's logits against the same model run through the plain
             versions: with the whole model in float32 within 1e-4
             relative L2 error (bf16's reading is printed, not held).

Float32 matmuls and convolutions run in full float32 here:
``allow_tf32`` is switched off for both cuBLAS and cuDNN, so the f32
comparisons are not blurred by TF32's ~3 decimal digits.

Every failed check raises and the script exits non-zero.  The last line
is ``{"ok": true, "device": {...}}``; the line before it is the card's
name and power limit from nvidia-smi, and the one before that the
``{"kernels": [...]}`` summary.  Without a GPU (or without the repo's
``src/`` beside this file) it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PHASES = ("build", "kernels", "serve")

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak and
# the float32 peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# serve phase, whole model in float32: relative L2 error of the kernel
# path's logits against the plain path's
LOGITS_TOL_F32 = 1e-4

REPLACES = {
    "paged_decode_attention":
        "src/repro/kernels/paged_attention/kernel.py:71",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:91",
}
SOURCES = {
    "paged_decode_attention":
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: {msg}")


def time_ms(fn, *, warmup=3, reps=25):
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event-timed runs."""
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
    emit({"phase": "build", "seconds": seconds,
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in libs.items()},
          "spill_lines": spills[:8]})


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


def paged_kv_rows(table, lengths, ps):
    """Distinct (page, offset) K/V rows that the lengths reach through
    the page table: the rows the function must read, each once.  A
    retired row (table all page 0) reaches at most the scratch page."""
    t = table.cpu().numpy().astype(np.int64)
    keys = []
    for b, n in enumerate(lengths):
        pos = np.arange(min(n, t.shape[1] * ps))
        keys.append(t[b, pos // ps] * ps + pos % ps)
    return int(np.unique(np.concatenate(keys)).size)


def check_close(name, out, ref, dtype):
    err = (out.float() - ref.float()).abs().max().item()
    tol = TOL[dtype]
    finite = bool(torch.isfinite(out.float()).all())
    ok = finite and bool(torch.allclose(out.float(), ref.float(),
                                        rtol=tol, atol=tol))
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {err}, tol {tol}, finite {finite})")
    return err


def phase_kernels():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_ref, keep_mask)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = {"stablelm-3b": dict(H=32, KVH=32, d=80),
              "gqa-40:8": dict(H=40, KVH=8, d=128)}
    B, ps, N = 8, 16, 64
    lengths = [1024, 777, 512, 300, 129, 64, 1, 600]   # last: retired slot
    results = []
    for dname, dtype in (("bfloat16", torch.bfloat16),
                         ("float32", torch.float32)):
        es = torch.finfo(dtype).bits // 8
        for sname, sh in shapes.items():
            H, KVH, d = sh["H"], sh["KVH"], sh["d"]
            G = H // KVH
            # -- paged decode
            q, kp, vp, table, lens = paged_case(
                gen, B=B, ps=ps, N=N, dtype=dtype, lengths=lengths,
                **sh)
            out = pa_ops.paged_decode_attention(q, kp, vp, table, lens)
            ref = paged_decode_attention_ref(q, kp, vp, table, lens)
            err = check_close(f"paged {sname} {dname}", out, ref, dname)

            def sdpa_paged():
                idx = table.long()
                k = kp[idx].reshape(B, N * ps, KVH, d).transpose(1, 2)
                v = vp[idx].reshape(B, N * ps, KVH, d).transpose(1, 2)
                if G > 1:
                    k = k.repeat_interleave(G, 1)
                    v = v.repeat_interleave(G, 1)
                valid = torch.arange(N * ps, device="cuda")[None] \
                    < lens[:, None]
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=valid[:, None, None])

            toks = sum(min(x, N * ps) for x in lengths)
            rows = paged_kv_rows(table, lengths, ps)
            nbytes = 2 * q.numel() * es + 2 * rows * KVH * d * es \
                + table.numel() * 4 + lens.numel() * 4
            flops = 4 * toks * H * d
            b_ms, b_by = bound(nbytes, flops, dname)
            results.append(dict(
                kernel="paged_decode_attention", shape=sname, dtype=dname,
                B=B, H=H, KVH=KVH, d=d, ps=ps, lengths=lengths,
                kv_rows=rows, max_abs_err=err, tol=TOL[dname],
                ms=time_ms(lambda: pa_ops.paged_decode_attention(
                    q, kp, vp, table, lens)),
                plain_ms=time_ms(lambda: paged_decode_attention_ref(
                    q, kp, vp, table, lens)),
                library_ms=time_ms(sdpa_paged),
                bound_ms=b_ms, bound_by=b_by))
            emit({"phase": "kernels", **results[-1]})

            # -- flash, exact causal and with a ragged padded prefix
            S = 256
            for pad, plen in ((0, 0), (512, 384)):
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
                out = fa_ops.flash_attention(q, k, v, **kw)
                ref = flash_attention_ref(q, k, v, **kw)
                err = check_close(f"flash {sname} pad={pad} {dname}", out,
                                  ref, dname)
                keep = keep_mask(S, T, prefix_pad=pad, prefix_len=plen,
                                 device="cuda")

                def sdpa_flash():
                    kk, vv = k.transpose(1, 2), v.transpose(1, 2)
                    if G > 1:
                        kk = kk.repeat_interleave(G, 1)
                        vv = vv.repeat_interleave(G, 1)
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), kk, vv, attn_mask=keep)

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
                    tol=TOL[dname],
                    ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw)),
                    plain_ms=time_ms(lambda: flash_attention_ref(
                        q, k, v, **kw)),
                    library_ms=time_ms(sdpa_flash),
                    bound_ms=b_ms, bound_by=b_by))
                emit({"phase": "kernels", **results[-1]})
    return results


# ---------------------------------------------------------------------------
# phase 3: serve full-width stablelm-3b


def phase_serve(seed):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("stablelm-3b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, params, max_slots=8, max_len=1024,
                           page_size=16, prefill_chunk=256,
                           prefix_cache_budget=256 << 20, device="cuda")
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, cfg.vocab_size, size=384)]
    suf_lens = [32, 41, 50, 59, 68, 77, 86, 96]
    prompts = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                     size=n)]
               for n in suf_lens]

    async def serve():
        await engine.warm_prefix(prefix)
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=32) for p in prompts])
        await engine.stop()
        return outs

    pa_ops.paged_decode_attention.launches = 0
    fa_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    outs = asyncio.run(serve())
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"paged_decode_attention":
                pa_ops.paged_decode_attention.launches,
                "flash_attention": fa_ops.flash_attention.launches}

    st = engine.stats()
    L = cfg.num_layers
    for i, o in enumerate(outs):
        if len(o) != 32 or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"request {i}: {len(o)} tokens, or a token outside the vocab")
    if st["prefill_tokens_reused"] <= 0:
        fail("the shared prefix was not reused")
    if st["kv_admit_copies"] != 0:
        fail(f"kv_admit_copies {st['kv_admit_copies']} != 0")
    if launches["paged_decode_attention"] != L * st["steps"]:
        fail(f"paged decode launched {launches['paged_decode_attention']} "
             f"times for {st['steps']} decode steps of {L} layers")
    if launches["flash_attention"] != L * st["prefill_chunks"]:
        fail(f"flash launched {launches['flash_attention']} times for "
             f"{st['prefill_chunks']} prefill chunks of {L} layers")

    # -- one prefill and one decode step, kernels vs plain versions
    prompt = prompts[-1]
    comparisons, inp = kernel_vs_plain(model, params, prompt)
    with torch.no_grad():
        # prefill-chunk times at the serve phase's shapes
        chunk_ms = {
            "cold_256": time_ms(lambda: model.prefill(
                params, {"tokens": inp["tokens"][:, :256]}, capacity=256),
                warmup=1, reps=5),
            "prefix512_suffix128": time_ms(lambda: model.prefill(
                params, {"tokens": inp["suffix"]}, capacity=128,
                **inp["prefix_kw"]), warmup=1, reps=5),
        }

    # a second wave of requests over the warm prefix, under the profiler
    wave = [prefix + [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                  size=n)]
            for n in suf_lens]
    profile = profile_wave(engine, wave)
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

    dec = sorted(engine.decode_step_s)
    emit({"phase": "serve", "model": cfg.name, "layers": L,
          "params": model.num_params(), "init_s": init_s,
          "serve_s": serve_s, "requests": len(prompts),
          "new_tokens": sum(len(o) for o in outs),
          "decode_steps": st["steps"],
          "decode_step_median_ms": statistics.median(dec) * 1e3,
          "decode_step_p90_ms": dec[int(0.9 * (len(dec) - 1))] * 1e3,
          "decode_tokens_per_s": st["decode_tokens"]
          / max(sum(engine.decode_step_s), 1e-9),
          "prefill_chunks": st["prefill_chunks"],
          "prefill_chunk_ms": chunk_ms,
          "prefill_tokens_computed": st["prefill_tokens_computed"],
          "prefill_tokens_reused": st["prefill_tokens_reused"],
          "kv_admit_copies": st["kv_admit_copies"],
          "paged": st["paged"], "launches": launches,
          "logits_vs_plain": {"bfloat16": logits_bf16,
                              "float32": logits_f32},
          "profiled_wave": profile, "peak_memory_gb": peak_gb})
    return launches


def plain_attention():
    """Patch the model's attention to call the kernels' plain versions."""
    from unittest import mock

    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    return mock.patch.multiple(
        "repro_torch.models.attention",
        fa_ops=mock.Mock(flash_attention=flash_attention_ref),
        pa_ops=mock.Mock(paged_decode_attention=paged_decode_attention_ref))


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
        with plain_attention():
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
        with plain_attention():
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
        with plain_attention():
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


def profile_wave(engine, prompts):
    """Serve ``prompts`` under ``torch.profiler``: the device's busy share
    of the wall time and device time by kernel (the full table goes to
    ``chiprun_out/serve_profile.txt``).  None where the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    async def wave():
        outs = await asyncio.gather(*[
            engine.generate(p, max_new_tokens=32) for p in prompts])
        await engine.stop()
        return outs

    steps0, chunks0 = engine.steps, engine.prefill_chunks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(wave())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "serve_profile.txt").write_text("".join(
        f"{dev:14.1f} us {cnt:8d}x  {key}\n" for dev, cnt, key in rows))
    if busy <= 0:
        return None
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "decode_steps": engine.steps - steps0,
            "prefill_chunks": engine.prefill_chunks - chunks0,
            "top_kernels": [{"name": key[:80], "ms": dev / 1e3,
                             "share_of_busy": dev / busy, "count": cnt}
                            for dev, cnt, key in rows[:8]]}


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

    kernel_rows, launches = [], {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        kernel_rows = phase_kernels()
    if "serve" in phases:
        launches = phase_serve(args.seed)

    summary = []
    for name in ("paged_decode_attention", "flash_attention"):
        # the main path's case: stablelm-3b in bf16 (flash with its prefix)
        rows = [r for r in kernel_rows if r["kernel"] == name
                and r["shape"] == "stablelm-3b" and r["dtype"] == "bfloat16"
                and r.get("prefix_pad", 512) == 512]
        if not rows:
            continue
        r = rows[0]
        summary.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches.get(name, 0),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
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
