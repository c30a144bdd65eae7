"""Training launcher (counterpart of ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch stablelm-3b --smoke --steps 50
    python -m repro_torch.launch.train --arch stablelm-3b --smoke --device cpu

``--smoke`` trains the reduced same-family config; without it the full
config trains on one card (whatever fits it).  ``--device`` defaults to
``cuda`` and raises without a GPU; ``cpu`` runs the plain versions of the
kernels.  Training runs in the fault-tolerant restart loop
(:mod:`repro_torch.training.train_loop`): atomic checkpoints,
deterministic resumable data, optional failure injection for drills
(``--fail-at-step``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="failure-injection drill")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.training.data import LMDataset
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.num_params()/1e6:.1f}M (config: "
          f"{'reduced smoke' if args.smoke else 'full'}) device={device}")

    dataset = LMDataset(vocab_size=cfg.vocab_size, batch_size=args.batch,
                        seq_len=args.seq)
    optimizer = AdamW(learning_rate=cosine_schedule(
        args.lr, warmup_steps=10, total_steps=args.steps))
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       fail_at_step=args.fail_at_step)
    state, history = train(model, tcfg, dataset=dataset,
                           optimizer=optimizer, device=device)
    print(f"done: final loss {history[-1][1]:.4f} "
          f"(first {history[0][1]:.4f})")


if __name__ == "__main__":
    main()
