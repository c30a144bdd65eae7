"""Device meshes (counterpart of ``repro/launch/mesh.py``).

A :class:`Mesh` is the port's ``jax.sharding.Mesh``: named axes over an
array of devices, held in one process.  Each shard of a tensor laid out
on it (:mod:`repro_torch.sharding.placement`) lives on its coordinate's
device, and the reductions over an axis are explicit functions of the
port (``placement.reduce_sum``, ``reduce_max``), so one controller drives
every shard, as the reference's single ``jax.jit`` program does.  A
device may repeat: ``make_serving_mesh(4, devices=["cuda:0"] * 4)`` puts
four tensor-parallel shards on one card, which runs the sharded program
at each shard's shapes without scaling it out.

Single pod: (16, 16) = ("data", "model").  Multi-pod: (2, 16, 16) =
("pod", "data", "model"); the "pod" axis carries only data parallelism.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


class Mesh:
    """``devices``: a nested list or array of devices (``torch.device`` or
    names), one axis per name in ``axis_names``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list:
        return list(self.devices.flat)

    def __repr__(self):
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


def _n(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def host_devices(device_type="cuda") -> list:
    """The host's devices of one type: every CUDA device, or the CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """The training mesh: (16, 16) or, multi-pod, (2, 16, 16).  Needs 256
    (512) devices: the host's CUDA devices, or ``devices`` (which may
    repeat one device, e.g. ``["meta"] * 256`` to plan layouts)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _n(shape)
    pool = list(devices) if devices is not None else host_devices()
    if len(pool) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(pool)}; pass "
            f"devices= (a device may repeat) to lay out shards without "
            f"that many cards")
    return Mesh(np.array(pool[:n], dtype=object).reshape(shape), axes)


def make_serving_mesh(tp: int = 1, *, devices=None):
    """A ``(1, tp)`` = ("data", "model") mesh for one serving engine.

    Serving shards only over the tensor axis (decode batches are too
    small and too dynamic for data parallelism inside one engine; the
    fleet scales out with whole replicas).  ``devices`` carves a slice of
    the host's devices for a fleet replica; it may repeat a device."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    pool = list(devices) if devices is not None else host_devices()
    if len(pool) < tp:
        raise RuntimeError(
            f"serving mesh tp={tp} needs {tp} devices, have {len(pool)}; "
            f"pass devices= (e.g. ['cuda:0'] * {tp}) to put several "
            f"shards on one device")
    return Mesh(np.array(pool[:tp], dtype=object).reshape(1, tp),
                ("data", "model"))


def make_host_mesh(device="cuda"):
    """A trivial 1-device mesh for smoke and integration runs: the card,
    as the reference's ``jax.devices()[:1]`` is its accelerator, unless
    the caller asks for another device (``device="cpu"``)."""
    return Mesh([[resolve_device(device)]], ("data", "model"))


def hardware_constants():
    """Per-card roofline figures of the NVIDIA H100 SXM5 80 GB, from
    NVIDIA's H100 Tensor Core GPU datasheet: dense bf16 tensor-core peak,
    HBM3 rate and size, and the NVLink 4 rate (900 GB/s a GPU, both
    directions, over 18 links)."""
    return {
        "peak_flops_bf16": 989e12,    # FLOP/s
        "hbm_bandwidth": 3.35e12,     # B/s
        "nvlink_bandwidth": 900e9,    # B/s per GPU, both directions
        "hbm_bytes": 80e9,
    }
