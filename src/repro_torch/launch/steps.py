"""The train step and the train state (counterpart of the training half of
``repro/launch/steps.py``).  The serving half (``lower_cell``, the
prefill and decode steps) and the sharding trees wait for ROADMAP §A.11
and §A.12.

The step runs eagerly: autograd through the model, whose flash, RG-LRU
and SSD calls are ``torch.autograd.Function`` s around the hand-written
forward kernels, then AdamW in place.  A profiler sees its parts as the
ranges ``train:forward`` (the forward and the loss), each Function's
backward (``train:backward:<wrapper>``, opened on autograd's own thread,
which a range about ``torch.autograd.grad`` would not see) and
``train:optimizer``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device
from repro_torch.training.tree import flatten, tree_map, unflatten


def cast_params(params, dtype):
    """Matrix weights (``ndim > 1``, float32; stacked layers count by
    their stacked shape, as in the reference) in ``dtype``, once, up
    front; the rest (norm scales, biases) stay as they are."""
    return tree_map(lambda p: p.to(dtype)
                    if p.dim() > 1 and p.dtype == torch.float32 else p,
                    params)


def device_batch(batch, device) -> dict:
    """A batch of numpy arrays (``LMDataset.batch``) as tensors on
    ``device``; tensors are moved as they are."""
    dev = resolve_device(device)
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(dev) for k, v in batch.items()}


def loss_and_grads(model, params, batch):
    """(loss, metrics, {key: gradient}) of ``model.loss_fn`` at ``params``
    cast by :func:`cast_params` to the activation dtype: the gradients
    are the uncast leaves' (their dtype), keyed by tree path."""
    flat = flatten(params)
    leaves = {k: p.detach().requires_grad_() for k, p in flat.items()}
    with record_function("train:forward"):
        loss, metrics = model.loss_fn(
            cast_params(unflatten(params, leaves),
                        torch_dtype(model.cfg.dtype)), batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(leaves, grads))


def make_train_step(model, optimizer):
    """→ train_step(state, batch) → (state, metrics): the loss and the
    float32 gradients of ``model.loss_fn`` at the cast parameters, summed
    over ``cfg.microbatches`` equal slices of the batch and divided by
    their count, then one ``optimizer.update`` (in place).  ``batch``
    holds tensors on the state's device."""
    M = max(model.cfg.microbatches, 1)

    def train_step(state, batch):
        params = state["params"]
        if M == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch)
        else:
            # gradient accumulation: one microbatch's activations live at
            # a time
            flat = flatten(params)
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for k, p in flat.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(flat.values())).device)
            mbs = {k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
                   for k, v in batch.items()}
            for i in range(M):
                loss, _, g = loss_and_grads(
                    model, params, {k: v[i] for k, v in mbs.items()})
                for k, gk in g.items():
                    gsum[k] += gk.float()
                lsum = lsum + loss
            grads = {k: g / M for k, g in gsum.items()}
            loss = lsum / M
            metrics = {}
        with record_function("train:optimizer"):
            new_params, new_opt, opt_metrics = optimizer.update(
                unflatten(params, grads), state["opt"], params)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def init_train_state(model, optimizer, seed=0, *, device="cuda") -> dict:
    """{"params", "opt", "step"}: parameters from the model's seeded init
    on ``device`` (``seed`` an int or a ``torch.Generator``), the
    optimizer's state, step 0.  With master weights the float32 master is
    taken first and the params become the working copy in the
    activation dtype."""
    params = model.init(seed, device=device)
    opt = optimizer.init(params)
    if optimizer.master_weights:
        adt = torch_dtype(model.cfg.dtype)
        params = tree_map(lambda p: p.to(adt), params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}
