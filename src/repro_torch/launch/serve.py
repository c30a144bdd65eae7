"""Serving launcher (counterpart of ``repro/launch/serve.py``): bring up
the continuous-batching engine (or a routed replica fleet) on a reduced
config and run a demo workload of concurrent requests through it.

    python -m repro_torch.launch.serve --arch stablelm-3b --requests 8
    python -m repro_torch.launch.serve --replicas 4 --router-policy prefix_affinity
    python -m repro_torch.launch.serve --replicas 2 --device cpu
    python -m repro_torch.launch.serve --tp 2 --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma-9b --tp 2 --device cpu

``--device`` defaults to ``cuda`` and raises without a GPU; ``cpu`` runs
the plain versions of the kernels.  Parameters come from the port's
seeded init (seed 0).  ``--tp`` > 1 gives every replica a
tensor-parallel mesh over ``tp`` devices: the host's CUDA devices, or on
the CPU the one CPU device repeated; every decoder-only family shards
(the encoder-decoder engine is refused at any ``tp``).
"""

from __future__ import annotations

import argparse
import asyncio
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--tp", type=int, default=1,
                    help="devices per engine (tensor parallelism)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the dispatch router")
    ap.add_argument("--router-policy", default="prefix_affinity",
                    choices=["prefix_affinity", "least_outstanding",
                             "weighted"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving.fleet import EngineFleet
    from repro_torch.serving.tokenizer import ByteTokenizer

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(0, device=device)
    devices = [device] * (args.replicas * args.tp) \
        if device.type == "cpu" else None
    fleet = EngineFleet(model, params, replicas=args.replicas, tp=args.tp,
                        policy=args.router_policy, max_slots=args.slots,
                        max_len=128, device=device, devices=devices)
    tok = ByteTokenizer(cfg.vocab_size)
    backend = fleet.dispatcher

    async def client(i):
        prompt = f"request {i % max(1, args.requests // 4)}: hello"
        t0 = time.perf_counter()
        out = await backend.generate(prompt,
                                     max_tokens=args.max_new_tokens,
                                     temperature=0.0, stop=None)
        dt = time.perf_counter() - t0
        return i, dt, tok.encode(out)

    async def run():
        results = await asyncio.gather(*[client(i)
                                         for i in range(args.requests)])
        await fleet.stop()
        return results

    t0 = time.perf_counter()
    results = asyncio.run(run())
    wall = time.perf_counter() - t0
    for i, dt, out in results:
        print(f"req {i}: {dt*1e3:7.1f} ms  {len(out)} tokens")
    steps = sum(e.steps for e in fleet.engines)
    toks = sum(e.decode_tokens for e in fleet.engines)
    print(f"\n{args.requests} requests in {wall:.2f}s over "
          f"{args.replicas} replica(s) (tp={args.tp}) on {device}; "
          f"{toks} decode tokens over {steps} steps")
    print(fleet.stats.report())


if __name__ == "__main__":
    main()
