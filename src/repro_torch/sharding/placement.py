"""Tensors laid out on a :class:`~repro_torch.launch.mesh.Mesh`, and the
reductions over its axes.

The port's counterpart of ``jax.device_put(x, NamedSharding(mesh, spec))``
and of ``lax.psum`` / ``lax.pmax`` inside the reference's sharded
programs.  Everything runs in one process: a :class:`ShardedTensor` holds
one local tensor per mesh coordinate, each on that coordinate's device,
and :func:`reduce_sum` / :func:`reduce_max` combine one tensor per shard
explicitly.  Both reduce in rank order on the first shard's device and
copy the result back to every shard's device, so the result does not
depend on where the shards live.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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


def place(x: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``x`` split per ``sharding``: each coordinate's slice, contiguous,
    on its device."""
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    made = {}
    for coord in np.ndindex(mesh.devices.shape):
        sl = shard_slices(x.shape, sharding.spec, mesh, coord)
        dev = mesh.devices[coord]
        key = (tuple((s.start, s.stop) for s in sl), str(dev))
        if key not in made:
            made[key] = x[sl].to(dev).contiguous()
        shards[coord] = made[key]
    return ShardedTensor(sharding, x.shape, x.dtype, shards)


def place_tree(tree, shardings):
    """:func:`place` over a tree of dicts and its tree of shardings."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    return place(tree, shardings)


def model_ranks(mesh, axis="model") -> list:
    """The mesh coordinates along ``axis``, the other axes at 0; every
    other axis must have size 1."""
    if any(n != 1 for a, n in mesh.shape.items() if a != axis):
        raise ValueError(f"{mesh}: only the {axis!r} axis may exceed 1 here")
    pos = mesh.axis_names.index(axis)
    return [tuple(r if i == pos else 0 for i in range(len(mesh.axis_names)))
            for r in range(mesh.shape[axis])]


def local_tree(tree, coord):
    """The local tensors of a tree of :class:`ShardedTensor` at ``coord``."""
    if isinstance(tree, dict):
        return {k: local_tree(v, coord) for k, v in tree.items()}
    return tree.local(coord)


def local_zeros(shape, dtype, spec, mesh, coord) -> torch.Tensor:
    """Zeros of one shard of a ``shape`` tensor laid out by ``spec``, on
    ``coord``'s device, without making the global tensor."""
    sl = shard_slices(shape, spec, mesh, coord)
    return torch.zeros([s.stop - s.start for s in sl], dtype=dtype,
                       device=mesh.devices[coord])


class ShardedParams:
    """A model's parameters on a tensor-parallel mesh (every axis but
    ``model`` of size 1): ``specs`` (the resolved spec tree),
    ``shards[r]`` (rank r's local parameter tree) and ``devices[r]``.
    The model functions take it in place of a parameter tree and run the
    tensor-parallel path (:mod:`repro_torch.models.lm`)."""

    def __init__(self, params, specs, mesh):
        self.mesh = mesh
        self.specs = specs
        self.ranks = model_ranks(mesh)
        tree = place_tree(params, named(mesh, specs))
        self.shards = [local_tree(tree, c) for c in self.ranks]
        self.devices = [mesh.devices[c] for c in self.ranks]

    @property
    def tp(self) -> int:
        return len(self.ranks)


# ---------------------------------------------------------------------------
# reductions over one mesh axis: one tensor per shard, in rank order


def broadcast(x: torch.Tensor, devices) -> list:
    """``x`` on each of ``devices`` (the same tensor where the device is
    ``x``'s own)."""
    copies = {x.device: x}
    out = []
    for d in devices:
        d = torch.device(d)
        if d not in copies:
            copies[d] = x.to(d)
        out.append(copies[d])
    return out


_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


def _reduce(parts, op):
    parts = list(parts)
    dev0, dt = parts[0].device, parts[0].dtype
    wide = _WIDEN.get(dt, dt)
    acc = parts[0].to(wide)
    for p in parts[1:]:
        acc = op(acc, p.to(dev0, wide))
    return broadcast(acc.to(dt), [p.device for p in parts])


def reduce_sum(parts) -> list:
    """The sum of one tensor per shard, on every shard's device: added in
    rank order on the first shard's device (bf16 and f16 in float32, then
    rounded once), then copied back."""
    return _reduce(parts, torch.add)


def reduce_max(parts) -> list:
    """The elementwise maximum of one tensor per shard, on every shard's
    device."""
    return _reduce(parts, torch.maximum)


def gather(parts, dim: int) -> torch.Tensor:
    """One tensor per shard concatenated along ``dim`` in rank order, on
    the first shard's device."""
    dev0 = parts[0].device
    return torch.cat([p.to(dev0) for p in parts], dim=dim)


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
    ``regroup.copies``."""
    out = []
    for t, (ranges, dev) in enumerate(zip(want, devices)):
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
                pieces.append(parts[src][..., at - a:end - a].to(dev))
                regroup.pieces += 1
                regroup.copies += src != t
                at = end
        out.append(torch.cat(pieces, -1) if len(pieces) > 1 else pieces[0])
    return out


regroup.pieces = 0
regroup.copies = 0


def even_bounds(n: int, tp: int) -> list:
    """The column ranges of an even split of ``n`` columns ``tp`` ways."""
    if n % tp:
        raise ValueError(f"{n} columns do not split {tp} ways")
    w = n // tp
    return [(r * w, (r + 1) * w) for r in range(tp)]
