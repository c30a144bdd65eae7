"""The train step, the train state and its layout on a mesh (counterpart
of ``repro/launch/steps.py``): ``pick_microbatches``,
``abstract_train_state`` (meta tensors) and ``train_state_pspecs``.
``lower_cell`` (the reference's XLA lowering for the dry-run) waits for
ROADMAP A.12b.

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
from repro_torch.sharding import rules as R
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


def pick_microbatches(cfg, shape, mesh, *, target_bytes=None) -> int:
    """Choose gradient-accumulation depth so the remat-saved per-layer
    hidden states (the dominant training activation term) fit the
    per-device budget: saved ≈ tokens/device × d_model × 2 B × n_layers
    (the reference's rule)."""
    if target_bytes is None:
        target_bytes = (2 if cfg.num_experts else 4) * 2**30
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    model_size = sizes.get("model", 1)
    tokens_per_chip = shape.global_batch * shape.seq_len // max(dp, 1)
    saved = tokens_per_chip * cfg.d_model * 2 * cfg.num_layers
    if cfg.num_experts:
        # expert dispatch buffers per device ≈ 3·K·cf·N_global·D·2/E-shards
        tokens_global = shape.global_batch * shape.seq_len
        expert_buf = (3 * cfg.num_experts_per_tok * cfg.moe_capacity_factor
                      * tokens_global * cfg.d_model * 2 / model_size)
        saved = max(saved, expert_buf)
    m = 1
    while saved / m > target_bytes and m < shape.global_batch // max(dp, 1):
        m *= 2
    return m


def abstract_train_state(model, optimizer=None) -> dict:
    """The train state as ``meta`` tensors: params (in the activation
    dtype under master weights), float32 moments (and master), int32
    count and step."""
    master = optimizer is not None and optimizer.master_weights
    params = model.abstract_params(dtype=model.cfg.dtype if master
                                   else None)

    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    def scalar():
        return torch.empty((), dtype=torch.int32, device="meta")

    opt = {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
           "count": scalar()}
    if master:
        opt["master"] = tree_map(f32, params)
    return {"params": params, "opt": opt, "step": scalar()}


def train_state_pspecs(rls, model, optimizer=None) -> dict:
    """The train state's specs under ``rls``: params by the rules,
    moments (and master) in the FSDP layout, scalars replicated."""
    pspec = R.params_pspecs(rls, model)
    mspec = R.opt_state_pspecs(rls, model)
    opt = {"mu": mspec, "nu": mspec, "count": ()}
    if optimizer is not None and optimizer.master_weights:
        opt["master"] = mspec
    return {"params": pspec, "opt": opt, "step": ()}
