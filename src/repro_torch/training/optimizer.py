"""AdamW with global-norm clipping and a cosine schedule, over the port's
nested dicts of tensors (counterpart of ``repro/training/optimizer.py``).

The arithmetic is the reference's, op for op: the global norm in float32
with ``+ 1e-9`` under the clip, bias correction by the step count, and
``p32 - lr * (step + weight_decay * p32)``; ``torch.optim.AdamW`` orders
decay and epsilon otherwise, so its numbers differ.  Unlike the
reference, which returns new trees, :meth:`AdamW.update` writes the
moments and the parameters (or the float32 master copy) in place, a leaf
at a time, so that a step holds one leaf's temporaries beside the state
rather than a second copy of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .tree import flatten, tree_map


def cosine_schedule(base_lr, warmup_steps, total_steps, min_frac=0.1):
    """step → learning rate (a float32 tensor): linear warm-up to
    ``base_lr``, then a cosine down to ``min_frac · base_lr``."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


@dataclass(frozen=True)
class AdamW:
    learning_rate: object = 3e-4          # float or callable(step)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # the train state's params are the working copy in the activation
    # dtype and the float32 master lives in the optimizer state
    master_weights: bool = False

    def init(self, params) -> dict:
        """{"mu", "nu": float32 zeros like params, "count": int32 0 [,
        "master": a float32 copy of params]}, on the params' device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = next(iter(flatten(params).values())).device
        st = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
              "count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.master_weights:
            st["master"] = tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)
        return st

    def _lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return torch.tensor(self.learning_rate, dtype=torch.float32,
                            device=step.device)

    @staticmethod
    def sum_squares(grads):
        """The float32 sum of squares of a tree of gradients, leaf by leaf
        in order."""
        return sum(torch.sum(torch.square(g.float()))
                   for g in flatten(grads).values())

    @torch.no_grad()
    def update(self, grads, state, params, *, gnorm=None):
        """One step → (params, state, {"grad_norm", "lr"}).  ``state``'s
        moments and master and ``params`` are updated in place (and
        returned); ``grads`` are read only.  ``gnorm``: the global norm,
        where the tree is one coordinate's shards of a larger one (a
        sharded step sums :meth:`sum_squares` over the mesh)."""
        count = state["count"] + 1
        g_flat = flatten(grads)
        if gnorm is None:
            gnorm = torch.sqrt(self.sum_squares(grads))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1, b2 = self.b1, self.b2
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        lr = self._lr(count)
        mu, nu = flatten(state["mu"]), flatten(state["nu"])
        p_flat = flatten(params)
        master = flatten(state["master"]) if self.master_weights else None
        for key, g in g_flat.items():
            g = g.float() * scale
            m, v = mu[key], nu[key]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            p = p_flat[key]
            p32 = master[key] if master is not None else p.float()
            step = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            delta = lr * (step + self.weight_decay * p32)
            if p32 is p or master is not None:
                p32.sub_(delta)
                if master is not None:
                    p.copy_(p32)
            else:
                p.copy_(p32 - delta)
        new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
        if master is not None:
            new_state["master"] = state["master"]
        return params, new_state, {"grad_norm": gnorm, "lr": lr}
