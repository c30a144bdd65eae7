"""Gradient compression: int8 error-feedback all-reduce (counterpart of
``repro/training/compression.py``).

Gradients are quantized to int8 with shared per-chunk scales before the
data-parallel reduction, and the quantization residual is fed back into
the next step's gradient (error feedback).  Protocol per chunk of 256
values:

  1. ``reduce_max`` of per-chunk abs-max → shared scale  (n/256 floats)
  2. int8 quantize with the shared scale
  3. ``reduce_sum`` of payloads (int8 values, int32 accumulation)
  4. dequantize mean; residual → error buffer for the next step

Wire bytes ≈ n·1B + n/256·4B vs n·4B for fp32 → ~3.9× reduction.

The reference runs this inside ``shard_map`` with ``lax.pmax`` /
``lax.psum`` over a named mesh axis.  The port's shards along the axis
are explicit: :func:`ef_compress_psum` takes one tensor per shard, in
rank order, and reduces them with
:func:`~repro_torch.sharding.placement.reduce_max` and
:func:`~repro_torch.sharding.placement.reduce_sum`, in the reference's
order of operations.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.placement import reduce_max, reduce_sum
from repro_torch.training.tree import flatten, tree_map, unflatten


def _once(fn, *per_shard):
    """``fn`` over each shard's arguments, computed once for shards whose
    arguments are the same tensors (a reduction's result on a shared
    device)."""
    done = {}
    out = []
    for args in zip(*per_shard):
        key = tuple(id(a) for a in args)
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def ef_compress_psum(g_flat, err, chunk=256):
    """One error-feedback compressed mean over the shards of a mesh axis.
    ``g_flat``, ``err``: one [n] float32 tensor per shard (shard-local
    values), in rank order.  → (the mean on every shard, each shard's new
    error), lists in rank order."""
    corrected = [g + e for g, e in zip(g_flat, err)]
    n = corrected[0].shape[0]
    pad = (-n) % chunk
    xps = [F.pad(c, (0, pad)).reshape(-1, chunk) for c in corrected]
    amax = [xp.abs().amax(dim=1, keepdim=True) for xp in xps]
    # XLA folds the division by 127 into a product with its float32
    # reciprocal; so does the port, to agree with it bit for bit
    scales = _once(lambda m: m * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=m.device) + 1e-12,
        reduce_max(amax))
    qs = [torch.clamp(torch.round(xp / s), -127, 127).to(torch.int8)
          for xp, s in zip(xps, scales)]
    # the residual in one rounding, as XLA's fused multiply-subtract
    # gives it: q·scale is exact in float64 (int8 times a float32)
    new_err = [(c.double() - (q.double() * s.double()).reshape(-1)[:n])
               .float() for c, q, s in zip(corrected, qs, scales)]
    nshards = float(len(g_flat))
    qsum = reduce_sum([q.to(torch.int32) for q in qs])
    mean = _once(lambda t, s: (t.float() * s).reshape(-1)[:n] / nshards,
                 qsum, scales)
    return mean, new_err


def make_compressed_dp_allreduce(mesh: Mesh, axis_name="data", chunk=256):
    """Returns f(grads, errs) -> (mean_grads, new_errs): every leaf
    averaged over the ``axis_name`` shards of ``mesh`` through the int8-EF
    protocol.  ``grads`` and ``errs`` are one tree per shard (a list, in
    rank order) and so are the results; a single tree stands for the same
    value on every shard (the reference's replicated inputs) and gives
    back shard 0's results."""
    n = mesh.shape[axis_name]

    def run(grads, errs):
        replicated = not isinstance(grads, (list, tuple))
        if replicated:
            grads, errs = [grads] * n, [errs] * n
        if len(grads) != n or len(errs) != n:
            raise ValueError(f"{len(grads)} gradient and {len(errs)} error "
                             f"trees for {n} shards of {axis_name!r}")
        flat_g = [flatten(g) for g in grads]
        flat_e = [flatten(e) for e in errs]
        means = [{} for _ in range(n)]
        new_errs = [{} for _ in range(n)]
        for key, g0 in flat_g[0].items():
            mean, new_e = ef_compress_psum(
                [fg[key].reshape(-1).float() for fg in flat_g],
                [fe[key] for fe in flat_e], chunk)
            for r in range(n):
                means[r][key] = mean[r].reshape(g0.shape).to(g0.dtype)
                new_errs[r][key] = new_e[r]
        means = [unflatten(grads[r], means[r]) for r in range(n)]
        new_errs = [unflatten(grads[r], new_errs[r]) for r in range(n)]
        return (means[0], new_errs[0]) if replicated else (means, new_errs)

    return run


def init_error_buffers(grads_like):
    """A float32 zero error buffer ``[size]`` per gradient leaf."""
    return tree_map(lambda g: torch.zeros((g.numel(),), dtype=torch.float32,
                                          device=g.device), grads_like)


def wire_bytes(n_values: int, chunk=256) -> int:
    """Modeled wire bytes per shard for one compressed reduction."""
    return n_values * 1 + (n_values // chunk + 1) * 4
