"""Offline trace analysis: ``python -m repro_torch.obs trace.json``.

Reads a Chrome-trace JSON written by
:func:`repro_torch.obs.write_chrome_trace` and prints the critical-path
report; ``--timeline`` adds the ASCII timeline, ``--top N`` widens the
blocker list.
"""

from __future__ import annotations

import argparse

from .export import load_spans, render_timeline
from .report import report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Critical-path report over an exported trace.")
    ap.add_argument("trace", help="Chrome-trace JSON file "
                                  "(write_chrome_trace)")
    ap.add_argument("--timeline", action="store_true",
                    help="also render an ASCII timeline")
    ap.add_argument("--top", type=int, default=8,
                    help="number of blockers to list (default 8)")
    args = ap.parse_args(argv)

    spans = load_spans(args.trace)
    if not spans:
        print(f"{args.trace}: no complete spans found")
        return 1
    print(report(spans).render(top=args.top))
    if args.timeline:
        print()
        print(render_timeline(spans))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
