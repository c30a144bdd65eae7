"""The train step, the train state and its layout on a mesh (counterpart
of ``repro/launch/steps.py``): ``pick_microbatches``,
``abstract_train_state`` (meta tensors), ``train_state_pspecs``, the
sharded train step (:func:`make_mesh_train_step`), the prefill and
decode steps of a mesh, and :func:`lower_cell`, which builds one
dry-run cell's step and its abstract inputs, as the reference's builds
its XLA lowering.

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
from repro_torch.models.lm import MeshParams
from repro_torch.sharding import rules as R
from repro_torch.sharding.placement import (
    COLLECTIVES,
    NamedSharding,
    ShardedParams,
    ShardedTensor,
    data_rows,
    local_tree,
    on_row,
    place,
    place_tree,
    reduce_sum,
    shard_slices,
)
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


def make_train_step(model, optimizer, mesh=None):
    """→ train_step(state, batch) → (state, metrics): the loss and the
    float32 gradients of ``model.loss_fn`` at the cast parameters, summed
    over ``cfg.microbatches`` equal slices of the batch and divided by
    their count, then one ``optimizer.update`` (in place).  ``batch``
    holds tensors on the state's device.  With a ``mesh`` the sharded
    step (:func:`make_mesh_train_step`) over a state laid out by
    :func:`place_train_state`."""
    if mesh is not None:
        return make_mesh_train_step(model, optimizer, mesh)
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


# ---------------------------------------------------------------------------
# the train step under a mesh


def place_train_state(model, optimizer, state, mesh, rls=None) -> dict:
    """A train state laid out on ``mesh`` by :func:`train_state_pspecs`
    under ``rls`` (default ``make_rules(mesh, cfg)``): a
    :class:`~repro_torch.sharding.placement.ShardedTensor` a leaf, every
    coordinate holding its own copy of its slice (replicas take their
    own updates)."""
    rls = rls or R.make_rules(mesh, model.cfg)
    specs = train_state_pspecs(rls, model, optimizer)
    return place_tree(state, _named_tree(mesh, specs), share=False)


def _named_tree(mesh, specs):
    if isinstance(specs, dict):
        return {k: _named_tree(mesh, v) for k, v in specs.items()}
    return NamedSharding(mesh, tuple(specs))


def _canonical(st) -> set:
    """The coordinates whose local slice of ``st`` no earlier coordinate
    (in rank order) holds: each slice counted once in a global sum."""
    seen, out = set(), set()
    for c in np.ndindex(st.mesh.devices.shape):
        k = tuple((s.start, s.stop) for s in shard_slices(
            st.shape, st.spec, st.mesh, c))
        if k not in seen:
            seen.add(k)
            out.add(c)
    return out


def place_batch(rls, batch, *, share=True) -> dict:
    """A global batch laid out by ``batch_pspecs``: the batch dim over
    the data axes (where it splits), replicated over ``model``."""
    bspecs = R.batch_pspecs(rls, {k: v for k, v in batch.items()})
    return {k: place(v, NamedSharding(rls.mesh, tuple(bspecs[k])),
                     share=share) for k, v in batch.items()}


def row_batches(rls, batch) -> list:
    """Each data coordinate's slice of a batch (global tensors, or
    :func:`place_batch`'s), as its row's first coordinate holds it."""
    placed = {k: v if isinstance(v, ShardedTensor) else place_batch(
        rls, {k: v})[k] for k, v in batch.items()}
    return [{k: t.local(row[0]) for k, t in placed.items()}
            for row in data_rows(rls.mesh)]


def mesh_loss_and_grads(model, rls, ptree, batches):
    """(loss, metrics, {coordinate: {key: float32 gradient}}) of the mean
    of the rows' losses (:meth:`Model.loss_tp`; ``batches[i]`` row i's
    batch) at the parameters ``ptree`` (ShardedTensor leaves) cast by
    :func:`cast_params`; each coordinate's gradients are those of its
    local slices, keyed by tree path."""
    mesh = rls.mesh
    coords = list(np.ndindex(mesh.devices.shape))
    rows = data_rows(mesh)
    adt = torch_dtype(model.cfg.dtype)
    leaves = {c: {k: t.detach().requires_grad_() for k, t in
                  flatten(local_tree(ptree, c)).items()} for c in coords}
    locs = {c: cast_params(unflatten(local_tree(ptree, c), lv), adt)
            for c, lv in leaves.items()}
    mp = MeshParams(ptree, locs, rls.tp_strategy)
    with record_function("train:forward"), R.use_rules(rls):
        outs = model.loss_tp(mp, batches)
    loss = reduce_sum([lo / len(rows) for lo, _ in outs])[0]
    flat = [(c, k, t) for c in coords for k, t in leaves[c].items()]
    grads = torch.autograd.grad(loss, [t for _, _, t in flat],
                                allow_unused=True)
    got = {}
    for (c, k, t), g in zip(flat, grads):
        got.setdefault(c, {})[k] = (torch.zeros_like(t) if g is None
                                    else g).float()
    metrics = {n: torch.stack([m[n].detach().to(loss.device)
                               for _, m in outs]).mean() for n in outs[0][1]}
    return loss.detach(), metrics, got


def make_mesh_train_step(model, optimizer, mesh):
    """→ train_step(state, batch) → (state, metrics) on ``mesh``, one
    controller driving every coordinate.  ``state`` is
    :func:`place_train_state`'s; ``batch`` holds the global batch, split
    over the data axes by ``batch_pspecs``.

    Each data coordinate's row computes its slice's loss
    (:meth:`Model.loss_tp`); the step's loss is their mean (one
    ``reduce_sum``) and one backward gives every coordinate the float32
    gradient of its local slices: a leaf's gather
    (:func:`~repro_torch.sharding.placement.mesh_gather`) has the
    reduce-scatter for backward, and a replicated leaf's sums every use
    in rank order.  ``cfg.microbatches`` equal slices of each row's batch
    run one after another, their gradients summed and divided by their
    count.  Then :func:`mesh_update`."""
    rls = R.make_rules(mesh, model.cfg)
    M = max(model.cfg.microbatches, 1)

    def train_step(state, batch):
        mbs = microbatch_rows(rls, batch, M)
        gsum, lsum, metrics = None, None, {}
        for i in range(M):
            loss, m, got = mesh_loss_and_grads(
                model, rls, state["params"],
                [{k: v[i] for k, v in b.items()} for b in mbs])
            if gsum is None:
                gsum, lsum = got, loss
                metrics = m if M == 1 else {}
            else:   # out of place: replicas' gradients share storage
                for c, gs in got.items():
                    for k, g in gs.items():
                        gsum[c][k] = gsum[c][k] + g
                lsum = lsum + loss
        grads = {c: {k: g / M for k, g in gs.items()} for c, gs in
                 gsum.items()} if M > 1 else gsum
        om = mesh_update(optimizer, state, grads, mesh)
        return state, {"loss": lsum / M, **metrics, **om}

    return train_step


def microbatch_rows(rls, batch, M) -> list:
    """Each data row's batch slice as ``M`` microbatches: per row
    {key: [M, b / M, ...]}."""
    return [{k: v.reshape((M, v.shape[0] // M) + v.shape[1:])
             for k, v in b.items()} for b in row_batches(rls, batch)]


def mesh_update(optimizer, state, grads, mesh) -> dict:
    """AdamW over every coordinate of ``mesh`` with the reference's
    arithmetic, updating in place: each coordinate's moments (and float32
    master) and, through a view, its parameters' slice that they cover,
    from that slice of its gradients (``grads``: {coordinate: {key:
    float32 gradient}}).  Under ZeRO-2 the moments are split over the
    data axes where the parameters are replicated, so each data replica
    updates its moments' slice and :func:`_all_gather_params` hands every
    replica the others' slices; under ``zero2_master`` the parameters are
    the master cast to their dtype.  The global norm is a ``reduce_sum``
    of the coordinates' sums of squares over the moments' slices each
    holds first; ``state``'s step counted → the optimizer's metrics
    (those of the first coordinate)."""
    coords = list(np.ndindex(mesh.devices.shape))
    ptree, opt = state["params"], state["opt"]
    pflat, mflat = flatten(ptree), flatten(opt["mu"])
    rels = {k: _within(pflat[k], mflat[k]) for k in pflat}
    with record_function("train:optimizer"):
        canon = {k: _canonical(st) for k, st in mflat.items()}
        gloc = {c: {k: g[rels[k][c]] for k, g in grads[c].items()}
                for c in coords}
        sq = reduce_sum([optimizer.sum_squares(
            {k: g for k, g in gloc[c].items() if c in canon[k]})
            * torch.ones((), device=mesh.devices[c]) for c in coords])
        out = []
        for c, s2 in zip(coords, sq):
            params_c = unflatten(ptree, {k: st.local(c)[rels[k][c]]
                                         for k, st in pflat.items()})
            opt_c = local_tree(opt, c)
            _, _, om = optimizer.update(
                unflatten(ptree, gloc[c]), opt_c, params_c,
                gnorm=torch.sqrt(s2))
            opt["count"].shards[c].copy_(opt_c["count"] + 1)
            out.append(om)
        for k, st in pflat.items():
            if tuple(st.spec) != tuple(mflat[k].spec):
                _all_gather_params(st, rels[k], canon[k])
    for c in coords:
        state["step"].shards[c].add_(1)
    return out[0]


def _within(pst, mst) -> dict:
    """{coordinate: the slices, within its local parameter slice of
    ``pst``, of its local moment slice of ``mst``} (the whole slice where
    the layouts agree; under ZeRO-2 its data replica's part)."""
    out = {}
    for c in np.ndindex(pst.mesh.devices.shape):
        p = shard_slices(pst.shape, pst.spec, pst.mesh, c)
        m = shard_slices(mst.shape, mst.spec, mst.mesh, c)
        out[c] = tuple(slice(b.start - a.start, b.stop - a.start)
                       for a, b in zip(p, m))
    return out


@torch.no_grad()
def _all_gather_params(st, rels, owners):
    """ZeRO-2's all-gather over the data axes: every coordinate's local
    parameters take each slice that another coordinate of the same
    parameter slice updated (``owners``: the first holder of each moment
    slice; ``rels``: :func:`_within`)."""
    mesh = st.mesh
    coords = list(np.ndindex(mesh.devices.shape))
    region = {c: tuple((s.start, s.stop) for s in shard_slices(
        st.shape, st.spec, mesh, c)) for c in coords}
    recv = []
    for c in coords:
        n = 0
        for m in coords:
            if m not in owners or region[m] != region[c] \
                    or rels[m] == rels[c]:
                continue
            dst = st.local(c)[rels[m]]
            dst.copy_(st.local(m)[rels[m]])
            n += dst.numel() * dst.element_size()
        recv.append((c, n))
    if any(n for _, n in recv):
        COLLECTIVES.record("all-gather", recv)


# ---------------------------------------------------------------------------
# the serving steps of a mesh and the dry-run's cells


def place_params(model, rls, params) -> ShardedParams:
    """Serving parameters on the rules' mesh, every coordinate its own
    copy of its slice (:class:`ShardedParams`, gathered a row at a time
    over the axes :func:`~repro_torch.sharding.placement.gather_axes`
    names)."""
    return ShardedParams(params, R.params_pspecs(rls, model), rls.mesh,
                         share=False, strategy=rls.tp_strategy)


def place_cache(rls, cache) -> dict:
    """A contiguous cache laid out by ``cache_pspecs``."""
    specs = R.cache_pspecs(rls, cache)
    return place_tree(cache, _named_tree(rls.mesh, specs), share=False)


def _row_cache(cache, row):
    from repro_torch.models.lm import shard_key
    return {shard_key(r): local_tree(cache, c) for r, c in enumerate(row)}


def make_prefill_step(model, rls, capacity):
    """→ prefill_step(params, batch) over a mesh: each data coordinate's
    row prefills its batch slice with its gathered parameters (the
    contiguous cache in the rules' layout) → per row (last logits,
    {shard_key(r): rank r's cache})."""
    from repro_torch.models import encdec, lm

    def prefill_step(params, batch):
        out = []
        for i, b in enumerate(row_batches(rls, batch)):
            rp = params.row(i)
            with on_row(rp.coords):
                if model.is_encdec:
                    out.append(encdec.prefill_tp(model.cfg, rp, b,
                                                 capacity))
                else:
                    out.append(lm.prefill_tp(model.cfg, rp, b, capacity,
                                             contiguous=True))
        return out
    return prefill_step


def make_decode_step(model, rls, capacity):
    """→ decode_step(params, cache, tokens, positions) over a mesh: each
    data coordinate's row runs one contiguous decode step on its slice
    of the batch and its coordinates' caches (of ``capacity`` positions),
    in place → per row logits."""
    def decode_step(params, cache, tokens, positions):
        out = []
        rows = row_batches(rls, {"tokens": tokens, "positions": positions})
        for i, b in enumerate(rows):
            rp = params.row(i)
            with on_row(rp.coords):
                out.append(model.decode_step(
                    rp, _row_cache(cache, rp.coords), b["tokens"],
                    b["positions"], capacity=capacity)[0])
        return out
    return decode_step


class Lowered:
    """One dry-run cell built for its mesh (:func:`lower_cell`): ``kind``,
    ``step`` (the step to run), ``inputs`` (its abstract inputs, ``meta``
    tensors at global shapes), ``place()`` (the inputs laid out on the
    mesh, each coordinate its own local tensors), ``model`` and
    ``rules``."""

    def __init__(self, kind, step, inputs, place, model, rules):
        self.kind, self.step, self.inputs = kind, step, inputs
        self.place, self.model, self.rules = place, model, rules

    def run(self, placed):
        return self.step(*placed)


def make_microbatch_step(model, optimizer, mesh):
    """→ step(state, batch): the dry-run's train step, the sharded step
    (:func:`make_mesh_train_step`) cut to its first microbatch.  Every
    later microbatch repeats it (XLA's cost analysis, which the
    reference's record reads, counts a loop's body once too); with more
    than one, the float32 accumulator that keeps their sum is allocated
    first and held through the microbatch, as it is alive through every
    microbatch after the first, so the peak is theirs.  The optimizer
    then takes the one microbatch's gradients as they are."""
    rls = R.make_rules(mesh, model.cfg)
    M = max(model.cfg.microbatches, 1)

    def step(state, batch):
        ptree = state["params"]
        acc = None
        if M > 1:
            acc = {c: {k: torch.zeros_like(t, dtype=torch.float32)
                       for k, t in flatten(local_tree(ptree, c)).items()}
                   for c in np.ndindex(mesh.devices.shape)}
        loss, _, grads = mesh_loss_and_grads(
            model, rls, ptree,
            [{k: v[0] for k, v in b.items()}
             for b in microbatch_rows(rls, batch, M)])
        if acc is not None:
            for c, gs in grads.items():
                for k, g in gs.items():
                    acc[c][k] += g
            grads = acc
        return state, {"loss": loss, **mesh_update(optimizer, state, grads,
                                                    mesh)}
    return step


def lower_cell(cfg, shape, mesh, *, optimizer=None) -> Lowered:
    """Build one (arch × shape) cell on ``mesh`` as the reference's
    ``lower_cell`` does, under ``make_rules(mesh, cfg)``: a train step
    (microbatches by :func:`pick_microbatches`, AdamW; the first
    microbatch, :func:`make_microbatch_step`) over
    :func:`abstract_train_state`; a prefill of ``shape.seq_len`` over
    ``abstract_params(serve_param_dtype)``; or one contiguous decode step
    against an ``init_cache(global_batch, seq_len)`` cache."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamW
    model = build_model(cfg)
    rls = R.make_rules(mesh, cfg)
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        if cfg.microbatches == 1:
            m = pick_microbatches(cfg, shape, mesh)
            if m > 1:
                cfg = cfg.replace(microbatches=m)
                model = build_model(cfg)
        optimizer = optimizer or AdamW(
            master_weights=(cfg.param_strategy == "zero2_master"))
        state = abstract_train_state(model, optimizer)
        step = make_microbatch_step(model, optimizer, mesh)
        return Lowered("train", step, (state, specs), lambda: (
            place_train_state(model, optimizer, state, mesh, rls),
            place_batch(rls, specs, share=False)), model, rls)
    params = model.abstract_params(dtype=cfg.serve_param_dtype or None)
    if shape.kind == "prefill":
        return Lowered("prefill", make_prefill_step(model, rls,
                                                    shape.seq_len),
                       (params, specs), lambda: (
                           place_params(model, rls, params),
                           place_batch(rls, specs, share=False)),
                       model, rls)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
    def place_decode():
        tok = place_batch(rls, {"tokens": specs["tokens"],
                                "positions": specs["positions"]},
                          share=False)
        return (place_params(model, rls, params), place_cache(rls, cache),
                tok["tokens"], tok["positions"])
    return Lowered("decode", make_decode_step(model, rls, shape.seq_len),
                   (params, cache, specs["tokens"], specs["positions"]),
                   place_decode, model, rls)
