"""Whether the SSD chunk scan's distance from its plain version comes from
its 3xTF32 products and from nothing else in the kernel.

Builds ``src/repro_torch/kernels/ssd/csrc/ssd.cu`` twice: as shipped (the
products in 3xTF32 on the tensor cores) and with ``-DSSD_F32_PRODUCTS``
(the same kernels, fragments, skips and order of sums, every product an
exact float32 FMA on the CUDA cores).  For each build it runs, on one
card, ``chip_smoke.py``'s SSD kernel rows against the plain version, the
kernel's and the plain version's distance from a float64 step recurrence
at S = 2048, and full-width mamba2-2.7b (seeded random weights, as ``chip_smoke.py``'s
``serve_ssm`` phase makes them) through the kernel path and the plain
path: the last logits of a 2100-token prefill and of the next decode
step, with the whole model in float32 and in bfloat16.  Prints one JSON
line a build and the card's name and power limit.

    python3 scripts/ssd_f32_witness.py [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402

DEFINE = "-DSSD_F32_PRODUCTS"


def build_f32_products() -> Path:
    """The witness library, built apart from ``_build``'s."""
    src = _build.sources()["ssd"]
    out = _build.BUILD_DIR / "ssd-f32-products.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.tool("nvcc"), *_build.NVCC_FLAGS, DEFINE, "-o",
                    str(out), str(src)], check=True, capture_output=True)
    return out


def use_library(path):
    """Make the SSD wrapper launch the kernels of ``path`` (None: the
    shipped build)."""
    _build._libs.pop("ssd", None)
    if path is None:
        return
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in ssd_ops._SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _build._libs["ssd"] = lib


def vs_float64(seed, S=2048, H=80, P=64, N=128):
    """The kernel's and the plain version's distance from the step
    recurrence in float64 (``chip_smoke.ssd_vs_float64``), on one batch
    row drawn as ``chip_smoke.py``'s SSD rows draw it."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xh = torch.randn(1, S, H, P, generator=gen, device="cuda")
    dt = F.softplus(torch.randn(1, S, H, generator=gen, device="cuda"))
    a_log = torch.ones(H, device="cuda")
    Bm = torch.randn(1, S, N, generator=gen, device="cuda")
    Cm = torch.randn(1, S, N, generator=gen, device="cuda")
    inputs = (xh, dt, a_log, Bm, Cm)
    return chip_smoke.ssd_vs_float64(inputs, {
        name: fn(*inputs, chunk=256)
        for name, fn in (("kernel", ssd_ops.ssd_chunked),
                         ("plain", ssd_chunked_ref))})


def model_logits(seed, dtype):
    """chip_smoke.py's kernel-vs-plain comparison of mamba2-2.7b."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("mamba2-2.7b")
    if dtype == torch.float32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    params = model.init(seed, device="cuda", dtype=dtype)
    rng = np.random.RandomState(seed)
    prompts = [[int(t) for t in rng.randint(0, cfg.vocab_size, size=n)]
               for n in chip_smoke.SSM_PROMPTS]
    prompt = prompts[chip_smoke.SSM_PROMPTS.index(chip_smoke.COMPARE_PROMPT)]
    out = chip_smoke.logits_agreement(
        chip_smoke.ssm_kernel_vs_plain(model, params, prompt,
                                       chip_smoke.MAX_LEN),
        cfg.vocab_size, None, str(dtype))
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_f32_witness: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    witness = build_f32_products()
    for form, path in (("3xtf32", None), ("f32_fma", witness)):
        use_library(path)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        rows = chip_smoke.ssd_kernel_rows(gen)
        print(json.dumps({
            "products": form,
            "kernel_rows": [{k: r.get(k) for k in (
                "S", "h0", "decay", "max_abs_err", "ms", "functions_ms")}
                for r in rows],
            "vs_float64": vs_float64(args.seed),
            "logits_vs_plain": {
                "float32": model_logits(args.seed, torch.float32),
                "bfloat16": model_logits(args.seed, torch.bfloat16)}}),
            flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
