"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Loads the cell's configuration and mix
(``BENCHMARK.json``), makes the weights and the traffic from the seed,
warms up, measures for ``--seconds``, checks what the window served, and
prints the result as the last line of standard output (the numbers
compared, each beside its limit, as the last lines of standard error and
under ``checks`` in the result).  ``--trace 1`` prints the cell's
per-layer metrics, read under ``torch.profiler``; ``--trace 0`` its
end-to-end metrics.  Needs the CUDA devices the cell asks for: without
them it exits 2 and prints no result.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from bench.harness import load_cell, run_cell
    chips = load_cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, line in out["checks"].items():
        print(f"check {name}: {line['value']} (limit {line['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
