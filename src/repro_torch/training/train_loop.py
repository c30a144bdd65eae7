"""Fault-tolerant training loop (counterpart of
``repro/training/train_loop.py``).

The run loop is a crash-restart loop around the train step:

  * checkpoint every ``ckpt_every`` steps (atomic; optionally async,
    overlapping the write with compute),
  * on a step failure (an injected fault) the loop restores the latest
    checkpoint and resumes; the data pipeline is stateless-resumable
    (batch = f(seed, step)), so no samples are skipped or repeated.

Failure injection for tests and drills: ``fail_at_step`` raises inside
the loop at a chosen step, once per call of :func:`train`.  The step runs
eagerly; capturing it in a CUDA graph is later work.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.device import resolve_device

from . import checkpoint as ckpt
from .data import LMDataset
from .optimizer import AdamW


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    async_ckpt: bool = True
    log_every: int = 10
    fail_at_step: int = -1      # failure injection (once)
    max_restarts: int = 3
    seed: int = 0


class InjectedFailure(RuntimeError):
    pass


def train(model, tcfg: TrainConfig, *, dataset: LMDataset | None = None,
          optimizer: AdamW | None = None, log=print, device="cuda"):
    """Train ``model`` for ``tcfg.steps`` steps on ``device`` → (final
    train state, [(step, loss), ...] every ``log_every`` steps and at the
    last)."""
    # late import: launch.steps imports the training package
    from repro_torch.launch.steps import (device_batch, init_train_state,
                                          make_train_step)

    dev = resolve_device(device)
    cfg = model.cfg
    optimizer = optimizer or AdamW(learning_rate=1e-3)
    dataset = dataset or LMDataset(
        vocab_size=cfg.vocab_size, batch_size=8, seq_len=32, seed=tcfg.seed)
    step_fn = make_train_step(model, optimizer)
    saver = ckpt.AsyncSaver() if tcfg.async_ckpt else None

    injected = False
    restarts = 0
    history = []

    while True:
        # (re)initialize, then restore the latest checkpoint if any
        state = init_train_state(model, optimizer, tcfg.seed, device=dev)
        step = 0
        if ckpt.latest_step(tcfg.ckpt_dir) is not None:
            state, step = ckpt.restore(tcfg.ckpt_dir, state, device=dev)
            log(f"[restore] resumed from step {step}")
        try:
            while step < tcfg.steps:
                if step == tcfg.fail_at_step and not injected:
                    injected = True
                    raise InjectedFailure(f"injected fault at step {step}")
                batch = device_batch(dataset.batch(step), dev)
                state, metrics = step_fn(state, batch)
                step += 1
                if step % tcfg.log_every == 0 or step == tcfg.steps:
                    loss = float(metrics["loss"])
                    history.append((step, loss))
                    log(f"[train] step {step} loss {loss:.4f}")
                if step % tcfg.ckpt_every == 0 or step == tcfg.steps:
                    if saver:
                        saver.save(tcfg.ckpt_dir, step, state)
                    else:
                        ckpt.save(tcfg.ckpt_dir, step, state)
            if saver:
                saver.wait()
            return state, history
        except InjectedFailure as e:
            restarts += 1
            log(f"[fault] {e}; restart {restarts}/{tcfg.max_restarts}")
            if saver:
                saver.wait()
            if restarts > tcfg.max_restarts:
                raise
