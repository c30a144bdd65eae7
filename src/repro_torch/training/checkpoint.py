"""Checkpointing in the reference's layout (counterpart of
``repro/training/checkpoint.py``): a checkpoint written by either package
restores in the other.

Layout: ``<dir>/step_<n:08d>/`` holding one ``.npy`` per leaf and
``manifest.json`` = ``{"step", "leaves": {key: {file, shape, dtype}}}``.
A leaf's key is its ``/``-joined path in the tree, its file the key with
``/`` replaced by ``__`` plus ``.npy``.  Writes go to a temporary
directory that is renamed into place (``os.replace``), so a crash
mid-save never leaves a partial ``step_*`` directory.  The save can run
in a background thread (:class:`AsyncSaver`) to overlap with the next
steps.

bfloat16: the reference saves ``np.asarray`` of the leaf, which for a
bfloat16 array is an ``ml_dtypes.bfloat16`` array; ``np.save`` writes it
with the descriptor ``'<V2'`` (raw 2-byte records) and the manifest names
it ``"bfloat16"``.  The port writes the same header and bytes without
``ml_dtypes``, and restores a leaf whose manifest says ``"bfloat16"`` by
reading its records as bfloat16.  (The reference's own ``restore`` cannot
read such a file back: ``np.load`` gives ``|V2``, which JAX refuses.)
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.placement import ShardedTensor, place

from .tree import flatten, unflatten

BF16_DESCR = "<V2"


def _snapshot(leaf) -> tuple:
    """(numpy array, manifest dtype) of a leaf on the host, as the
    reference's ``np.asarray`` gives it; bfloat16 as its raw 16-bit
    records (int16, written under ``BF16_DESCR``).  A copy: the train
    step updates its tensors in place while an async save writes.  A
    :class:`ShardedTensor` is written whole, assembled on the host."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    """Write one leaf as ``np.save`` writes the reference's."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _write(ckpt_dir, step: int, leaves: dict) -> Path:
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {}
    for key, (arr, dtype) in leaves.items():
        fname = key.replace("/", "__") + ".npy"
        _write_leaf(tmp / fname, arr, dtype)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype}
    (tmp / "manifest.json").write_text(json.dumps(
        {"step": step, "leaves": manifest}))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic
    return final


def save(ckpt_dir, step: int, tree) -> Path:
    """Write ``tree`` (nested dicts of tensors or arrays) as checkpoint
    ``step``; → its directory."""
    return _write(ckpt_dir, step, {k: _snapshot(v)
                                   for k, v in flatten(tree).items()})


class AsyncSaver:
    """Overlap checkpoint writes with training (one in flight at a time)."""

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, ckpt_dir, step, tree):
        self.wait()
        # copy to the host on the calling thread (a consistent snapshot),
        # write in the background
        snap = {k: _snapshot(v) for k, v in flatten(tree).items()}
        self._thread = threading.Thread(
            target=_write, args=(ckpt_dir, step, snap), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")]
    return max(steps) if steps else None


def _read_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def restore(ckpt_dir, tree_like, *, step=None, shardings=None,
            device="cuda"):
    """Restore into the structure of ``tree_like`` → (tree of tensors on
    ``device`` in the saved dtypes, step).  ``step`` defaults to the
    latest.  ``shardings`` (a tree of
    :class:`~repro_torch.sharding.placement.NamedSharding` of the same
    structure, e.g. ``named(mesh, train_state_pspecs(...))``) restores
    onto a mesh instead: every leaf becomes a
    :class:`~repro_torch.sharding.placement.ShardedTensor` split per its
    spec over the mesh's devices, whatever mesh wrote the checkpoint
    (elastic restore)."""
    dev = resolve_device(device) if shardings is None else None
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    where = flatten(shardings) if shardings is not None else None
    out = {}
    for key in flatten(tree_like):
        info = manifest[key]
        leaf = _read_leaf(d / info["file"], info["dtype"])
        out[key] = leaf.to(dev) if where is None else place(leaf, where[key])
    return unflatten(tree_like, out), step
