"""The control of a cell's correctness check, on the card.

    python3 bench/control.py --workload <cell> --seconds <s> --seeds 1 2 3

runs the cell's window once a seed (in one process, at the cell's own
load and sizes) and reads, on the same sampled requests, the widest
served-token logit gap of the program and that of the fp8 reference's
first token (``reference.logits_at(..., quant="fp8")``).  The
benchmark's runs do not run it; its readings set the upper end of the
cell's limit (``limits/<cell>.json``).  One JSON line a seed.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from bench.harness import run_cell
    if not torch.cuda.is_available():
        print("bench: control.py needs a CUDA card", file=sys.stderr)
        return 2
    t = T_PROCESS
    for seed in args.seeds:
        out = run_cell(args.workload, seed, args.seconds, False,
                       device="cuda", t_process=t, control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          **out["control"],
                          "metrics": out["metrics"],
                          "checks": out["checks"]}), flush=True)
        t = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
