"""Tensors laid out on a :class:`~repro_torch.launch.mesh.Mesh`, and the
collectives over its axes.

The port's counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))``
and of ``lax.psum`` / ``lax.pmax`` / ``all_gather`` inside the reference's
sharded programs.  Everything runs in one process: a
:class:`ShardedTensor` holds one local tensor per mesh coordinate, each on
that coordinate's device, and the collectives combine one tensor per
shard explicitly, in rank order.  :func:`reduce_sum` / :func:`reduce_max`
reduce on the first shard's device and copy the result back to every
shard's device, so the result does not depend on where the shards live.

The data axes (``pod``, ``data``): :func:`data_rows` lists each data
coordinate's row of ``model`` coordinates, and :func:`mesh_gather` hands
each coordinate a leaf gathered over the axes its use needs (the FSDP
all-gather of the ``embed`` dim over ``data``; under the ulysses
strategies also the weights they use whole over ``model``, :func:`gather_axes`);
its backward is the reduce-scatter,
each local slice receiving the sum, in rank order, of every use of it.

Every collective is an autograd Function, so gradients cross shards by
the transposed collective (a broadcast's transpose sums, a gather's
slices, an all-reduce's is itself; an output no use reached gives its
backward None, not a tensor of zeros), and each adds to
:data:`COLLECTIVES` by the reference's kinds (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``): a count of calls and the bytes the receiving
coordinates take in.  Those bytes are what each receiver gets from other
coordinates (an all-gather its peers' parts, an all-reduce a ring's
2(n−1)/n of the tensor, a reduce-scatter its slice from each other
contributor, a broadcast the tensor at every other shard); they differ
from the reference's dry-run figure, the result shapes of the
collectives in XLA's optimised HLO.

A :data:`TRACKER` (the dry-run's, :mod:`repro_torch.launch.dryrun`) may
watch the collectives: it learns each tensor's coordinate, receives each
collective's bytes per coordinate, and gives every receiver its own
copy.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

# the dry-run's tracker of coordinates, or None (see the module docstring)
TRACKER = None
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


class CollectiveCounter:
    """Per kind: ``count`` (calls) and ``bytes`` (what the receiving
    coordinates took in, summed over them)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.stats = {k: {"count": 0, "bytes": 0} for k in KINDS}

    def record(self, kind, received):
        """One call of ``kind``; ``received``: (receiving tensor or
        coordinate, bytes) per receiver."""
        st = self.stats[kind]
        st["count"] += 1
        st["bytes"] += int(sum(n for _, n in received))
        if TRACKER is not None:
            TRACKER.collective(kind, received)

    def snapshot(self) -> dict:
        return {k: dict(v) for k, v in self.stats.items()}


COLLECTIVES = CollectiveCounter()


def _quiet():
    return TRACKER.quiet() if TRACKER is not None \
        else contextlib.nullcontext()


def _coord(t):
    return TRACKER.coord(t) if TRACKER is not None else None


def _put(t, coord):
    """``t`` as coordinate ``coord``'s own tensor (the tracker's copy)."""
    return TRACKER.put(t, coord) if TRACKER is not None \
        and coord is not None else t


@contextlib.contextmanager
def on_row(coords):
    """The mesh coordinates of the row whose program runs inside: a
    broadcast to ``devices[r]`` is a copy for ``coords[r]``."""
    if TRACKER is None:
        yield
        return
    with TRACKER.row(coords):
        yield


def _row_coords(n):
    row = TRACKER.current_row() if TRACKER is not None else None
    return list(row) if row is not None and len(row) == n else [None] * n


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True)
class NamedSharding:
    """A spec (one entry per dim: None, an axis name or a tuple of names)
    on a mesh."""
    mesh: object
    spec: tuple


def named(rules_or_mesh, spec_tree):
    """Every spec of a tree of dicts as a :class:`NamedSharding` on the
    rules' mesh (or on a mesh)."""
    mesh = getattr(rules_or_mesh, "mesh", rules_or_mesh)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return NamedSharding(mesh, tuple(spec_tree))


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(shape, spec, mesh, coord) -> tuple:
    """The slices of a ``shape`` tensor that mesh coordinate ``coord``
    holds under ``spec`` (tuple axes split major to minor, as JAX does)."""
    sizes = mesh.shape
    at = dict(zip(mesh.axis_names, coord))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, spec):
        n, idx = 1, 0
        for a in _entry_axes(entry):
            n *= sizes[a]
            idx = idx * sizes[a] + at[a]
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways under {spec}")
        out.append(slice(idx * (dim // n), (idx + 1) * (dim // n)))
    return tuple(out)


class ShardedTensor:
    """A global tensor of ``shape`` on ``sharding.mesh``: ``shards[coord]``
    is the local tensor at each mesh coordinate, on its device.
    Coordinates that hold the same slice on the same device share one
    tensor."""

    def __init__(self, sharding: NamedSharding, shape, dtype, shards):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> tuple:
        return self.sharding.spec

    def local(self, coord) -> torch.Tensor:
        return self.shards[tuple(coord)]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor assembled from the shards on ``device``
        (default: the first shard's)."""
        first = self.shards.flat[0]
        dev = torch.device(device) if device is not None else first.device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for coord in np.ndindex(self.shards.shape):
            sl = shard_slices(self.shape, self.spec, self.mesh, coord)
            out[sl] = self.shards[coord].to(dev)
        return out


def place(x: torch.Tensor, sharding: NamedSharding, *,
          share: bool = True) -> ShardedTensor:
    """``x`` split per ``sharding``: each coordinate's slice, contiguous,
    on its device.  With ``share`` coordinates that hold the same slice
    on the same device share one tensor; without it every coordinate
    holds a copy of its own (a train state, whose replicas each take
    their own update)."""
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for coord in np.ndindex(mesh.devices.shape):
        sl = shard_slices(x.shape, sharding.spec, mesh, coord)
        dev = mesh.devices[coord]
        key = (tuple((s.start, s.stop) for s in sl), str(dev))
        if share and key in made:
            shards[coord] = made[key]
            continue
        t = x[sl].to(dev)
        t = t.contiguous() if share else t.clone(
            memory_format=torch.contiguous_format)
        made[key] = shards[coord] = _put(t, coord)
    return ShardedTensor(sharding, x.shape, x.dtype, shards)


def place_tree(tree, shardings, *, share: bool = True):
    """:func:`place` over a tree of dicts and its tree of shardings."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k], share=share)
                for k, v in tree.items()}
    return place(tree, shardings, share=share)


def data_rows(mesh, axis="model") -> list:
    """One row a data coordinate (every axis but ``axis``, in rank
    order): the mesh coordinates of its ``axis`` ranks, in rank order."""
    names = mesh.axis_names
    shape = mesh.devices.shape
    pos = names.index(axis) if axis in names else None
    other = [n for i, n in enumerate(shape) if i != pos]
    rows = []
    for idx in np.ndindex(*other):
        row = []
        for r in range(shape[pos] if pos is not None else 1):
            c = list(idx)
            if pos is not None:
                c.insert(pos, r)
            row.append(tuple(c))
        rows.append(row)
    return rows


def model_ranks(mesh, axis="model") -> list:
    """The mesh coordinates along ``axis``, the other axes at 0 (the
    first data coordinate's row)."""
    return data_rows(mesh, axis)[0]


def local_tree(tree, coord):
    """The local tensors of a tree of :class:`ShardedTensor` at ``coord``."""
    if isinstance(tree, dict):
        return {k: local_tree(v, coord) for k, v in tree.items()}
    return tree.local(coord)


def local_zeros(shape, dtype, spec, mesh, coord) -> torch.Tensor:
    """Zeros of one shard of a ``shape`` tensor laid out by ``spec``, on
    ``coord``'s device, without making the global tensor."""
    sl = shard_slices(shape, spec, mesh, coord)
    return _put(torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                            device=mesh.devices[coord]),
                getattr(mesh, "tags", {}).get(coord, coord))


def drop_axes(spec, axes) -> tuple:
    """``spec`` with the mesh ``axes`` taken out of every entry: the
    layout of a leaf gathered over them."""
    out = []
    for entry in spec:
        kept = tuple(a for a in _entry_axes(entry) if a not in axes)
        out.append(None if not kept else kept[0] if len(kept) == 1
                   else kept)
    return tuple(out)


def spec_axes(spec) -> set:
    return {a for e in spec for a in _entry_axes(e)}


class ShardedParams:
    """A model's parameters on a mesh: ``specs`` (the resolved spec
    tree), ``tree`` (a :class:`ShardedTensor` a leaf), ``rows`` (each data
    coordinate's ``model`` coordinates, :func:`data_rows`), and for the
    first row ``ranks``, ``devices[r]`` and ``shards[r]`` (rank r's local
    parameter tree).  On a serving mesh (every data axis of size 1) the
    model functions take it in place of a parameter tree and run the
    tensor-parallel path (:mod:`repro_torch.models.lm`); with data axes
    above 1 each data coordinate's program takes :meth:`row`, its
    parameters gathered over the data axes."""

    def __init__(self, params, specs, mesh, *, share=True,
                 strategy="heads"):
        self.mesh = mesh
        self.specs = specs
        self.strategy = strategy
        self.tree = place_tree(params, named(mesh, specs), share=share)
        self.rows = data_rows(mesh)
        self._first_row(self.rows[0], [local_tree(self.tree, c)
                                       for c in self.rows[0]])

    def _first_row(self, ranks, shards):
        self.ranks = ranks
        self.shards = shards
        self.devices = [self.mesh.devices[c] for c in ranks]

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def dp(self) -> int:
        return len(self.rows)

    def gather_axes(self, path: str) -> tuple:
        return gather_axes(self.mesh, path, self.strategy)

    def row(self, i: int) -> "RowParams":
        """Data coordinate ``i``'s view: its ranks, and each rank's
        parameters gathered over :meth:`gather_axes` (a stacked layer
        subtree one layer at a time, as it is used:
        :meth:`RowParams.layer_tree`)."""
        return RowParams(self, i)


STACKED = ("layers", "enc_layers", "dec_layers")
VOCAB_LEAVES = ("embed", "lm_head")
# the attention subtrees, whose head_dim the ulysses strategies split over
# model, and the subtrees that every strategy runs in the heads layout
# (a recurrence along the whole sequence, MoE capacity over the row's
# whole token set): their width, heads and experts stay split
ATTENTION = ("attn", "self_attn", "cross_attn")
HEADS_LAYOUT = ("moe", "rglru", "ssd")


def gather_axes(mesh, path: str, strategy: str = "heads") -> tuple:
    """The mesh axes a leaf at ``path`` is gathered over before use: the
    data axes (FSDP, and ZeRO-2's replicas, whose gather moves nothing);
    over ``model`` too where the strategy computes with whole weights
    what the rules split: under ``ulysses_sp`` every leaf but the
    vocab-sharded tables and the heads-layout subtrees (each shard runs
    its sequence rows through whole layers), under ``ulysses`` and
    ``heads_sp`` the attention leaves (split over their head_dim)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    parts = set(path.split("/"))
    if strategy == "ulysses_sp":
        if path not in VOCAB_LEAVES and not parts & set(HEADS_LAYOUT):
            axes += ("model",)
    elif strategy in ("ulysses", "heads_sp") and parts & set(ATTENTION):
        axes += ("model",)
    return axes


def leaf_paths(tree, prefix=""):
    """(path, leaf) of every leaf of a tree of dicts, paths joined by
    ``/``."""
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaf_paths(v, p)
        else:
            yield p, v


def get_path(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def set_path(tree, path, value):
    ks = path.split("/")
    for k in ks[:-1]:
        tree = tree.setdefault(k, {})
    tree[ks[-1]] = value


def row_mesh(mesh, coords):
    """The mesh of one row: ``coords``' devices on a mesh whose every
    axis but ``model`` has size 1; ``tags`` maps its coordinates to
    ``coords`` (the row's place in the whole mesh)."""
    from repro_torch.launch.mesh import Mesh   # launch imports this module
    shape = [1] * len(mesh.axis_names)
    pos = mesh.axis_names.index("model")
    shape[pos] = len(coords)
    devs = np.empty(shape, dtype=object)
    tags = {}
    for r, c in enumerate(coords):
        local = tuple(r if i == pos else 0 for i in range(len(shape)))
        devs[local] = mesh.devices[c]
        tags[local] = c
    out = Mesh(devs, mesh.axis_names)
    out.tags = tags
    return out


class RowParams(ShardedParams):
    """One data coordinate's parameters (:meth:`ShardedParams.row`) on
    its row's own mesh (:func:`row_mesh`; ``coords`` its place in the
    whole mesh): ``specs`` with the gathered axes dropped, ``shards[r]``
    rank r's tree with every leaf outside the stacked layer subtrees
    gathered; a stacked subtree stays local until :meth:`layer_tree`
    gathers a layer of it (forward only: an inference row; a train step
    gathers in :func:`repro_torch.models.lm.mesh_layer`)."""

    def __init__(self, parent: ShardedParams, i: int):
        self.parent = parent
        self.index = i
        self.strategy = parent.strategy
        ranks = parent.rows[i]
        self.coords = ranks
        self.mesh = row_mesh(parent.mesh, ranks)
        self.rows = [list(self.mesh.tags)]
        shards = [{} for _ in ranks]
        self.specs = {}
        for path, st in leaf_paths(parent.tree):
            axes = parent.gather_axes(path)
            set_path(self.specs, path, drop_axes(st.spec, axes))
            if path.split("/")[0] in STACKED:
                for r, c in enumerate(ranks):
                    set_path(shards[r], path, st.local(c))
                continue
            for r, t in enumerate(mesh_gather(st, axes, ranks)):
                set_path(shards[r], path, t)
        self._first_row(self.rows[0], shards)

    def layer_tree(self, prefix: str, index: int) -> list:
        """Each rank's slice ``index`` of the stacked subtree ``prefix``
        (one layer, or one group of layers), gathered for use by
        :func:`mesh_gather` (forward only); the layer's layout and the
        coordinates' slices are kept on the parent for the other rows."""
        parent = self.parent
        layers = parent.__dict__.setdefault("_layers", {})
        coords = list(np.ndindex(parent.mesh.devices.shape))
        out = [{} for _ in self.ranks]
        for path, st in leaf_paths(get_path(parent.tree, prefix)):
            full = f"{prefix}/{path}"
            if full not in layers:
                layers[full] = ShardedTensor(
                    NamedSharding(st.mesh, tuple(st.spec)[1:]),
                    tuple(st.shape)[1:], st.dtype, None), {}
            layer, sel = layers[full]
            if index not in sel:
                sel[index] = [st.shards[c][index] for c in coords]
            with torch.no_grad():
                got = mesh_gather(layer, parent.gather_axes(full),
                                  self.coords, sel[index])
            for r, g in enumerate(got):
                set_path(out[r], path, g)
        return out


# ---------------------------------------------------------------------------
# gathering a leaf over mesh axes (the FSDP all-gather and its
# reduce-scatter)


def _groups(shape, spec, mesh, axes, coords):
    """For each of ``coords`` (in rank order) the region it gathers over
    ``axes`` (slices of the global ``shape``), and the coordinates whose
    distinct local slices make it up, with their slices relative to the
    region.  Remembered on the mesh by its arguments."""
    key = (tuple(shape), tuple(spec), tuple(axes), tuple(coords))
    cache = mesh.__dict__.setdefault("_gather_groups", {})
    if key not in cache:
        cache[key] = _make_groups(shape, spec, mesh, axes, coords)
    return cache[key]


def _make_groups(shape, spec, mesh, axes, coords):
    kept = drop_axes(spec, axes)
    regions, members = {}, {}
    for c in coords:
        reg = shard_slices(shape, kept, mesh, c)
        key = tuple((s.start, s.stop) for s in reg)
        regions[c] = key
        if key in members:
            continue
        seen, mem = set(), []
        for m in np.ndindex(mesh.devices.shape):
            sl = shard_slices(shape, spec, mesh, m)
            if any(a.start < b.start or a.stop > b.stop
                   for a, b in zip(sl, reg)):
                continue
            k = tuple((a.start, a.stop) for a in sl)
            if k in seen:
                continue
            seen.add(k)
            mem.append((m, tuple(slice(a.start - b.start, a.stop - b.start)
                                 for a, b in zip(sl, reg))))
        members[key] = mem
    return regions, members


def _assemble(shape, locs, rels, device):
    """The region ``shape`` from the pieces ``locs`` at ``rels`` (slices
    relative to it that tile it), on ``device``: concatenated along the
    first dim the pieces split, group by group."""
    if len(locs) == 1:
        return locs[0].to(device)
    starts = [tuple(r.start for r in rel) for rel in rels]
    varies = [d for d in range(len(shape))
              if len({st[d] for st in starts}) > 1]
    dim = varies[0]
    if len(varies) == 1:       # one dim splits: one concatenation
        order = sorted(range(len(locs)), key=lambda i: starts[i][dim])
        return torch.cat([locs[i].to(device) for i in order], dim)
    groups = {}
    for t, rel, st in zip(locs, rels, starts):
        groups.setdefault(st[dim], []).append((t, rel))
    parts = []
    for at in sorted(groups):
        members = groups[at]
        sub = [slice(0, n) for n in shape]
        sub[dim] = slice(0, members[0][1][dim].stop - at)
        parts.append(_assemble(
            tuple(s.stop for s in sub), [t for t, _ in members],
            [tuple(slice(r.start - (at if d == dim else 0),
                         r.stop - (at if d == dim else 0))
                   for d, r in enumerate(rel)) for _, rel in members],
            device))
    return torch.cat(parts, dim)


class _MeshGather(torch.autograd.Function):
    """Forward: each consumer coordinate's region, assembled from the
    local slices (an all-gather where the region holds more than one).
    Backward: each local slice's cotangent, the sum in rank order of the
    cotangents of every consumer whose region holds it (a reduce-scatter,
    and over replicas an all-reduce), each replica receiving the same."""

    @staticmethod
    def forward(ctx, plan, *locs):
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        sources, consumers, regions, members, shapes, devices, _ = plan
        at = dict(zip(sources, locs))
        ctx.src_devices = [t.device for t in locs]
        ctx.dtype = locs[0].dtype
        built, outs, recv = {}, [], []
        with _quiet():
            for c, dev in zip(consumers, devices):
                key = regions[c]
                if (key, dev) not in built:
                    mem = members[key]
                    built[key, dev] = _assemble(
                        shapes[key], [at[m] for m, _ in mem],
                        [rel for _, rel in mem], dev)
                t = built[key, dev]
                outs.append(t if not any(o is t for o in outs)
                            else t.view_as(t))
                mine = next((at[m] for m, _ in members[key] if m == c),
                            None)
                recv.append((c, _nbytes(t) - (_nbytes(mine)
                                              if mine is not None else 0)))
        outs = [_put(o, c) for o, c in zip(outs, consumers)]
        if any(n for _, n in recv):
            COLLECTIVES.record("all-gather", recv)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        sources, consumers, regions, members, _, _, own = ctx.plan
        sums, counts = {}, {}
        with _quiet():
            for c, g in zip(consumers, grads):
                if g is None:
                    continue
                key = regions[c]
                if key not in sums:
                    sums[key] = g.to(_WIDEN.get(g.dtype, g.dtype))
                    counts[key] = 1
                else:
                    sums[key] = sums[key] + g.to(sums[key].device,
                                                 sums[key].dtype)
                    counts[key] += 1
            sums = {k: v.to(ctx.dtype) for k, v in sums.items()}
            out, recv = [], []
            for src, dev in zip(sources, ctx.src_devices):
                key, rel = own[src]
                if key not in sums:
                    out.append(None)
                    continue
                g = sums[key][rel].to(dev).contiguous()
                out.append(g)
                recv.append((src, _nbytes(g) * (counts[key] - 1)))
        out = [None if g is None else _put(g, c)
               for g, c in zip(out, sources)]
        if any(n for _, n in recv):
            COLLECTIVES.record(
                "reduce-scatter" if any(len(members[k]) > 1 for k in sums)
                else "all-reduce", recv)
        return (None, *out)


def _plan(st, axes, consumers, sources=None):
    mesh = st.mesh
    sources = sources or list(np.ndindex(mesh.devices.shape))
    key = (tuple(st.shape), tuple(st.spec), axes, tuple(consumers),
           tuple(sources))
    cache = mesh.__dict__.setdefault("_gather_plans", {})
    if key not in cache:
        cache[key] = _make_plan(st, axes, consumers, sources)
    return cache[key]


def _make_plan(st, axes, consumers, sources):
    mesh = st.mesh
    regions, members = _groups(st.shape, st.spec, mesh, axes,
                               list(dict.fromkeys(consumers + sources)))
    shapes = {k: tuple(b - a for a, b in k) for k in members}
    own = {}      # each source's region and its slice within it
    for c in sources:
        key = regions[c]
        sl = shard_slices(st.shape, st.spec, mesh, c)
        own[c] = key, tuple(slice(a.start - b[0], a.stop - b[0])
                            for a, b in zip(sl, key))
    return (sources, list(consumers), regions, members, shapes,
            [mesh.devices[c] for c in consumers], own)


def mesh_gather(st: ShardedTensor, axes, consumers=None, locs=None) -> list:
    """The leaf ``st`` gathered over ``axes`` for each of ``consumers``
    (mesh coordinates; default every coordinate, in rank order), each on
    its coordinate's device, as one autograd Function over the local
    tensors (``locs``: one per coordinate in rank order, default
    ``st``'s shards; the differentiable leaves a train step holds)."""
    coords = list(np.ndindex(st.mesh.devices.shape))
    consumers = coords if consumers is None else list(consumers)
    locs = [st.shards[c] for c in coords] if locs is None else list(locs)
    return list(_MeshGather.apply(_plan(st, tuple(axes), consumers,
                                        coords), *locs))


# ---------------------------------------------------------------------------
# collectives over one row of shards: one tensor per shard, in rank order


_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def _copies(x, devices) -> list:
    """``x`` on each of ``devices``, one copy a distinct device (``x``
    itself on its own)."""
    copies = {x.device: x}
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = x.to(d)
    return [copies[torch.device(d)] for d in devices]


def _distinct(ts, avoid=None) -> list:
    """``ts`` with every repeat (and ``avoid``) replaced by a view: the
    outputs of an autograd Function must be tensors of their own."""
    out = []
    for t in ts:
        out.append(t.view_as(t) if t is avoid or any(o is t for o in out)
                   else t)
    return out


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, x):
        ctx.set_materialize_grads(False)
        ctx.src = _coord(x)
        ctx.device = x.device
        coords = _row_coords(len(devices))
        with _quiet():
            outs = _distinct(_copies(x, devices), avoid=x)
        outs = [_put(o, c) for o, c in zip(outs, coords)]
        if len(devices) > 1:
            COLLECTIVES.record("collective-permute",
                               [(c, _nbytes(x)) for c in coords[1:]])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        gs = [g for g in grads if g is not None]
        if not gs:
            return None, None
        with _quiet():
            acc = gs[0].to(ctx.device, _WIDEN.get(gs[0].dtype, gs[0].dtype))
            for g in gs[1:]:
                acc = acc + g.to(ctx.device, acc.dtype)
            acc = acc.to(gs[0].dtype)
        if len(grads) > 1:
            COLLECTIVES.record("all-reduce", [(ctx.src, _nbytes(acc)
                                               * (len(gs) - 1))])
        return None, _put(acc, ctx.src)


def broadcast(x: torch.Tensor, devices) -> list:
    """``x`` on each of ``devices`` (the same tensor where the device is
    ``x``'s own; the tracker's copy for each of the current row's
    coordinates).  Its transpose sums the receivers' cotangents."""
    if TRACKER is None and not (torch.is_grad_enabled() and x.requires_grad):
        out = _copies(x, devices)
        if len(out) > 1:
            COLLECTIVES.record("collective-permute",
                               [(None, _nbytes(x))] * (len(out) - 1))
        return out
    return list(_Broadcast.apply(list(devices), x))


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.set_materialize_grads(False)
        coords = [_coord(p) for p in parts]
        ctx.coords = coords
        ctx.devices = [p.device for p in parts]
        with _quiet():
            outs = _distinct(_reduce_plain(parts, torch.add))
        outs = [_put(o, c) for o, c in zip(outs, coords)]
        _record_all_reduce(parts)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        live = [g for g in grads if g is not None]
        if not live:
            return (None,) * len(grads)
        with _quiet():
            dev0 = ctx.devices[0]
            acc = live[0].to(dev0, _WIDEN.get(live[0].dtype, live[0].dtype))
            for g in live[1:]:
                acc = acc + g.to(dev0, acc.dtype)
            outs = _copies(acc.to(live[0].dtype), ctx.devices)
        _record_all_reduce(outs)
        return tuple(_put(o, c) for o, c in zip(_distinct(outs), ctx.coords))


def _record_all_reduce(parts):
    n = len(parts)
    if n > 1:
        COLLECTIVES.record("all-reduce", [
            (_coord(p) if TRACKER is not None else None,
             2 * (n - 1) * _nbytes(p) // n) for p in parts])


def _reduce_plain(parts, op):
    parts = list(parts)
    dev0, dt = parts[0].device, parts[0].dtype
    wide = _WIDEN.get(dt, dt)
    acc = parts[0].to(wide)
    for p in parts[1:]:
        acc = op(acc, p.to(dev0, wide))
    return _copies(acc.to(dt), [p.device for p in parts])


def reduce_sum(parts) -> list:
    """The sum of one tensor per shard, on every shard's device: added in
    rank order on the first shard's device (bf16 and f16 in float32, then
    rounded once), then copied back.  Its transpose is itself."""
    parts = list(parts)
    if TRACKER is None and not (torch.is_grad_enabled()
                                and any(p.requires_grad for p in parts)):
        _record_all_reduce(parts)
        return _reduce_plain(parts, torch.add)
    return list(_ReduceSum.apply(*parts))


def reduce_max(parts) -> list:
    """The elementwise maximum of one tensor per shard, on every shard's
    device; no gradient flows through it (the loss's logsumexp takes it
    as a constant shift)."""
    parts = [p.detach() for p in parts]
    _record_all_reduce(parts)
    with _quiet():
        outs = _reduce_plain(parts, torch.maximum)
    if TRACKER is None:
        return outs
    return [_put(o, _coord(p)) for o, p in zip(_distinct(outs), parts)]


class _Collect(torch.autograd.Function):
    """Receiver j gets ``cat(parts[i] for i in sets[j])`` along ``dim`` on
    ``devices[j]``; part i's cotangent is the sum in rank order of its
    slices of the receivers' cotangents."""

    @staticmethod
    def forward(ctx, dim, sets, devices, coords, *parts):
        ctx.set_materialize_grads(False)
        ctx.dim, ctx.sets = dim, sets
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.src = [(p.device, _coord(p)) for p in parts]
        outs, recv = [], []
        with _quiet():
            for js, dev in zip(sets, devices):
                outs.append(torch.cat([parts[i].to(dev) for i in js], dim)
                            if len(js) > 1 else parts[js[0]].to(dev)
                            .view_as(parts[js[0]]))
        for j, (js, c) in enumerate(zip(sets, coords)):
            recv.append((c, sum(_nbytes(parts[i]) for i in js if i != j)))
        outs = [_put(o, c) for o, c in zip(outs, coords)]
        COLLECTIVES.record("all-gather", recv)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.sizes)
        acc = [None] * n
        count = [0] * n
        with _quiet():
            for g, js in zip(grads, ctx.sets):
                if g is None:
                    continue
                off = 0
                for i in js:
                    piece = g.narrow(ctx.dim, off, ctx.sizes[i])
                    off += ctx.sizes[i]
                    dev = ctx.src[i][0]
                    wide = _WIDEN.get(piece.dtype, piece.dtype)
                    acc[i] = piece.to(dev, wide) if acc[i] is None \
                        else acc[i] + piece.to(dev, wide)
                    count[i] += 1
            dt = next(g.dtype for g in grads if g is not None)
            out = [None if a is None else a.to(dt).contiguous()
                   for a in acc]
        COLLECTIVES.record("reduce-scatter", [
            (c, _nbytes(o) * max(k - 1, 0))
            for o, (_, c), k in zip(out, ctx.src, count) if o is not None])
        return (None, None, None, None, *(
            None if o is None else _put(o, c)
            for o, (_, c) in zip(out, ctx.src)))


def gather(parts, dim: int) -> torch.Tensor:
    """One tensor per shard concatenated along ``dim`` in rank order, on
    the first shard's device."""
    parts = list(parts)
    return _Collect.apply(dim, [list(range(len(parts)))], [parts[0].device],
                          [_coord(parts[0])], *parts)[0]


def all_gather(parts, dim: int) -> list:
    """Every shard receives all parts concatenated along ``dim`` in rank
    order, on its own device."""
    parts = list(parts)
    n = len(parts)
    sets = [list(range(n))] * n
    return list(_Collect.apply(dim, sets, [p.device for p in parts],
                               [_coord(p) for p in parts], *parts))


def _regroup_run(plan, devices, parts):
    """→ (outs, received): each receiver's pieces of ``parts`` (by
    ``plan``) concatenated on its device (one piece: a view), and the
    bytes it reads from other shards."""
    outs, recv = [], []
    for t, (pieces, dev) in enumerate(zip(plan, devices)):
        got = [parts[src][..., a:b].to(dev) for src, a, b in pieces]
        outs.append(torch.cat(got, -1) if len(got) > 1 else got[0])
        recv.append((_coord(parts[t]), sum(
            _nbytes(g) for g, (src, _, _) in zip(got, pieces) if src != t)))
    return outs, recv


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, devices, *parts):
        ctx.set_materialize_grads(False)
        ctx.plan = plan
        ctx.src = [(p.shape, p.device, p.dtype, _coord(p)) for p in parts]
        with _quiet():
            outs, recv = _regroup_run(plan, devices, parts)
            outs = [o.contiguous() for o in outs]
        outs = [_put(o, _coord(p)) for o, p in zip(outs, parts)]
        COLLECTIVES.record("all-to-all", recv)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        with _quiet():
            out = [None] * len(ctx.src)
            for g, pieces in zip(grads, ctx.plan):
                if g is None:
                    continue
                off = 0
                for src, a, b in pieces:
                    shape, dev, dt, _ = ctx.src[src]
                    if out[src] is None:
                        out[src] = torch.zeros(shape, dtype=dt, device=dev)
                    out[src][..., a:b] += g[..., off:off + b - a].to(dev)
                    off += b - a
        COLLECTIVES.record("all-to-all", [
            (c, 0) for (_, _, _, c) in ctx.src])
        return (None, None, *(None if o is None else _put(o, s[3])
                              for o, s in zip(out, ctx.src)))


def regroup(parts, bounds, want, devices) -> list:
    """Move columns (the last dim) between shards into another layout.

    ``parts[r]`` holds the global columns ``[bounds[r][0], bounds[r][1])``
    of a tensor (its shard under the parameter layout, e.g. an even split
    of a fused projection); ``want[t]`` lists the global column ranges
    ``(lo, hi)`` shard t needs, in order.  → for each t, those columns
    concatenated, on ``devices[t]``.  A range is cut at the source shards'
    bounds and each piece read from shard t itself where it holds the
    columns, else from the lowest rank that does.  Counts every piece in
    ``regroup.pieces`` and those read from another shard in
    ``regroup.copies``.  Its transpose moves the cotangents back."""
    plan = []
    for t, ranges in enumerate(want):
        pieces = []
        for lo, hi in ranges:
            at = lo
            while at < hi:
                src = t if bounds[t][0] <= at < bounds[t][1] else next(
                    (r for r, (a, b) in enumerate(bounds) if a <= at < b),
                    None)
                if src is None:
                    raise ValueError(f"no shard holds column {at}")
                a, b = bounds[src]
                end = min(hi, b)
                pieces.append((src, at - a, end - a))
                regroup.pieces += 1
                regroup.copies += src != t
                at = end
        plan.append(pieces)
    if TRACKER is None and not (torch.is_grad_enabled()
                                and any(p.requires_grad for p in parts)):
        outs, recv = _regroup_run(plan, devices, parts)
        COLLECTIVES.record("all-to-all", recv)
        return outs
    return list(_Regroup.apply(plan, list(devices), *parts))


regroup.pieces = 0
regroup.copies = 0


def even_bounds(n: int, tp: int) -> list:
    """The column ranges of an even split of ``n`` columns ``tp`` ways."""
    if n % tp:
        raise ValueError(f"{n} columns do not split {tp} ways")
    w = n // tp
    return [(r * w, (r + 1) * w) for r in range(tp)]
