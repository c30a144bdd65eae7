"""Dry-run: every (architecture × input shape × mesh) cell of the
production meshes run on ``meta`` tensors (counterpart of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell with XLA on 256 (512)
placeholder devices and reads XLA's memory and cost analyses.  The port
has no compiler to ask: it runs each cell's step (:func:`~repro_torch.
launch.steps.lower_cell`) once, for every coordinate of the mesh, on
``meta`` tensors (shapes and dtypes, no storage), and measures what each
coordinate's program does.  One ``meta`` device stands for all 256 (512)
coordinates, so a coordinate cannot be read off a tensor's device:
:class:`Tracker`, a ``TorchDispatchMode``, tags every tensor with its
coordinate instead.

* Placed shards and batch slices are tagged where
  :mod:`~repro_torch.sharding.placement` makes them; an op's outputs take
  the tag of its first tagged input (a factory op's, the current row's
  first coordinate); the collectives tag what each receiver gets and run
  untracked inside.  Tags follow autograd's backward too, which no
  context variable set around a shard's forward would reach.
* FLOPs: each op's by ``torch.utils.flop_counter``'s formulas, and each
  kernel wrapper's own count on ``meta`` tensors (its ``*_work``), charged
  to the tag's coordinate.  The backward Functions recompute through the
  plain versions, which are counted as what they are.
* Memory: each coordinate's live bytes, a storage counted from the op
  that makes it until it is freed (a ``weakref.finalize`` on the
  storage, whose Python object PyTorch keeps while anything holds it),
  and their peak.  The arguments (parameters, optimizer state, cache,
  batch) are counted apart as well.
* Collectives: per coordinate, a count and the bytes received by kind
  (:data:`~repro_torch.sharding.placement.COLLECTIVES`; these are not
  the reference's HLO result bytes).

A train cell runs its step's first microbatch
(:func:`~repro_torch.launch.steps.make_microbatch_step`).  A cell is
``ok`` only when the run charged every coordinate with FLOPs.  A record
reports the largest coordinate in ``*_per_device``.  Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""

from __future__ import annotations

import argparse
import contextlib
import contextvars
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (
    ARCH_IDS,
    SHAPES,
    get_config,
    shape_applicable,
)
from repro_torch.kernels import _build
from repro_torch.models.model import Model
from repro_torch.serving.prefix_cache import tree_nbytes
from repro_torch.sharding import placement

_ROW: contextvars.ContextVar = contextvars.ContextVar("dryrun_row",
                                                      default=None)


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


_RUN = object()
_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _sig(x):
    """A hashable signature of an op's argument: a tensor by its layout,
    dtype and whether it is a ``meta`` tensor; raises TypeError for
    anything else than plain values."""
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.shape, x.stride(), x.is_meta)
    if isinstance(x, _ATOMS):
        return x
    if isinstance(x, (list, tuple)):
        return tuple([_sig(v) for v in x])
    raise TypeError(type(x))


def _template(func, args, out):
    """The layout of a functional op's outputs, or :data:`_RUN` for an op
    that mutates or aliases an input (or returns anything else)."""
    if func._schema.is_mutable or any(r.alias_info is not None
                                       for r in func._schema.returns):
        return _RUN
    outs = out if isinstance(out, (list, tuple)) else (out,)
    if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in outs):
        return _RUN
    ins = {t.untyped_storage()._cdata for t in _tensors(args)}
    if any(t.untyped_storage()._cdata in ins for t in outs):
        return _RUN
    lay = tuple((tuple(t.shape), t.stride(), t.dtype) for t in outs)
    return (type(out) if isinstance(out, (list, tuple)) else None, lay)


def _build_out(tmpl):
    kind, lay = tmpl
    outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
            for shape, stride, dt in lay]
    return outs[0] if kind is None else kind(outs)


class Tracker(TorchDispatchMode):
    """Tags, FLOPs, live and peak bytes and collectives per mesh
    coordinate, while active (``with Tracker() as t:``); installs itself
    as :data:`placement.TRACKER` and as the kernels' meter."""

    def __init__(self):
        super().__init__()
        self.tags = {}            # storage key -> coordinate
        self.flops = {}
        self.kernel_flops = {}
        self.live = {}
        self.peak = {}
        self.coll = {}
        self.kernels = {}
        self._quiet = 0
        self._memo = {}

    # -- the placement hooks -------------------------------------------------

    @staticmethod
    def _key(t):
        return t.untyped_storage()._cdata

    def coord(self, t):
        if not isinstance(t, torch.Tensor):
            return t
        return self.tags.get(self._key(t))

    @contextlib.contextmanager
    def quiet(self):
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    @contextlib.contextmanager
    def row(self, coords):
        tok = _ROW.set(list(coords))
        try:
            yield
        finally:
            _ROW.reset(tok)

    def current_row(self):
        return _ROW.get()

    def put(self, t, coord):
        """``t`` as ``coord``'s own tensor: tagged if it has no
        coordinate yet, else copied for it."""
        have = self.coord(t)
        if have == coord:
            return t
        if have is not None:
            with self.quiet():
                t = t.clone()
        self._own(t, coord)
        return t

    def collective(self, kind, received):
        for who, n in received:
            c = self.coord(who)
            if c is None:
                continue
            st = self.coll.setdefault(c, {}).setdefault(
                kind, {"count": 0, "bytes": 0})
            st["count"] += 1
            st["bytes"] += int(n)

    def meter(self, name, flops, nbytes, like):
        c = self.coord(like)
        if c is None:
            c = self._default()
        self.kernel_flops[c] = self.kernel_flops.get(c, 0) + int(flops)
        self.kernels[name] = self.kernels.get(name, 0) + 1

    # -- tracking ----------------------------------------------------------------

    def _default(self):
        row = _ROW.get()
        return row[0] if row else None

    def _own(self, t, coord):
        """Tag ``t``'s storage with ``coord``, counting its bytes live
        until the storage is freed."""
        if coord is None:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.tags:
            self.tags[key] = coord
            return
        self.tags[key] = coord
        n = st.nbytes()
        live = self.live.get(coord, 0) + n
        self.live[coord] = live
        if live > self.peak.get(coord, 0):
            self.peak[coord] = live
        weakref.finalize(st, self._free, key, coord, n)

    def _free(self, key, coord, n):
        self.tags.pop(key, None)
        self.live[coord] = self.live.get(coord, 0) - n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._call(func, args, kwargs)
        if self._quiet:
            return out
        coord = None
        for t in _tensors(args):
            coord = self.tags.get(self._key(t))
            if coord is not None:
                break
        if coord is None:
            coord = self._default()
            if coord is None:
                return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[coord] = self.flops.get(coord, 0) + int(
                flop_registry[packet](*args, **kwargs, out_val=out))
        for t in _tensors(out if isinstance(out, (list, tuple))
                          else (out,)):
            if t.device.type == "meta" and self._key(t) not in self.tags:
                self._own(t, coord)
        return out

    # -- the meta kernels, remembered by signature ----------------------------
    #
    # Many ``meta`` kernels are Python references (100 µs to 1 ms a call).
    # A functional op's outputs' shapes, strides and dtypes depend only on
    # its inputs' and its other arguments, so the first call of each
    # signature runs the kernel and later ones make empty outputs of the
    # remembered layout.  Ops that write an input or return a view of one
    # always run.

    def _call(self, func, args, kwargs):
        try:
            key = (func, _sig(args),
                   _sig(tuple(sorted(kwargs.items()))) if kwargs else ())
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        tmpl = self._memo.get(key)
        if tmpl is None:
            out = func(*args, **kwargs)
            self._memo[key] = _template(func, args, out)
            return out
        if tmpl is _RUN:
            return func(*args, **kwargs)
        return _build_out(tmpl)

    def __enter__(self):
        self._prev = (placement.TRACKER, _build.METER)
        placement.TRACKER = self
        _build.METER = self.meter
        return super().__enter__()

    def __exit__(self, *exc):
        placement.TRACKER, _build.METER = self._prev
        return super().__exit__(*exc)

    def arguments(self) -> dict:
        """The bytes each coordinate holds now (its arguments, when
        called after placing them)."""
        return dict(self.live)


def paged_kv_pool_bytes(cfg, *, num_pages: int, page_size: int) -> int:
    """Bytes the serving engine's *paged* KV pool allocates for a
    ``num_pages``-page pool: ``num_pages`` usable pages plus the reserved
    scratch page 0.  Raises ``ValueError`` for models whose KV is not
    positionally sliceable (they have no paged layout)."""
    return tree_nbytes(Model(cfg).init_paged_cache(num_pages + 1, page_size,
                                                   device="meta"))


def contiguous_kv_bytes(cfg, *, max_slots: int, max_len: int) -> int:
    """Bytes of the contiguous per-slot cache (recurrent, hybrid, int8,
    windowed and encoder-decoder models, and the dense opt-out)."""
    return tree_nbytes(Model(cfg).init_cache(max_slots, max_len,
                                             device="meta"))


def serving_kv_estimate(cfg, *, max_slots: int, max_len: int,
                        page_size: int = 16) -> dict:
    """Device-memory estimate of a decode cell's serving KV at the
    engine's default pool sizing (``num_pages = max_slots · max_len /
    page_size``), for both layouts; equal to what the engine allocates."""
    out = {
        "max_slots": max_slots,
        "max_len": max_len,
        "contiguous_bytes": contiguous_kv_bytes(
            cfg, max_slots=max_slots, max_len=max_len),
    }
    try:
        num_pages = max_slots * (max_len // page_size)
        out.update({
            "layout": "paged",
            "page_size": page_size,
            "num_pages": num_pages,
            "paged_bytes": paged_kv_pool_bytes(
                cfg, num_pages=num_pages, page_size=page_size),
        })
    except ValueError as e:  # non-sliceable KV: contiguous cache only
        out["layout"] = "contiguous"
        out["paged_unsupported"] = str(e)
    return out


def _largest(by_coord: dict):
    """(coordinate, value) of the largest value."""
    if not by_coord:
        return None, 0
    c = max(by_coord, key=lambda k: by_coord[k])
    return c, by_coord[c]


def measure_cell(cfg, shape, mesh) -> dict:
    """Run one cell's step for every coordinate on ``meta`` tensors →
    the per-coordinate measurements: ``arguments``, ``peak``, ``flops``
    (dispatch and kernels) and ``collectives`` by coordinate, ``ran``
    (the coordinates the run charged with FLOPs), plus the step and its
    rules."""
    from repro_torch.launch.steps import lower_cell
    placement.COLLECTIVES.reset()
    with Tracker() as tr:
        low = lower_cell(cfg, shape, mesh)
        placed = low.place()
        args = tr.arguments()
        tr.peak = dict(args)
        low.run(placed)
        del placed
    flops = {c: tr.flops.get(c, 0) + tr.kernel_flops.get(c, 0)
             for c in set(tr.flops) | set(tr.kernel_flops)}
    return {"lowered": low, "arguments": args, "peak": dict(tr.peak),
            "flops": flops, "kernel_flops": dict(tr.kernel_flops),
            "collectives": tr.coll, "kernels": dict(tr.kernels),
            "ran": {c for c, f in flops.items() if f > 0}}


def _collective_summary(coll: dict) -> dict:
    """The largest coordinate's collectives (by bytes received) by kind,
    with totals, as the reference's record lays them out."""
    totals = {c: sum(v["bytes"] for v in kinds.values())
              for c, kinds in coll.items()}
    c, _ = _largest(totals)
    kinds = coll.get(c, {})
    st = {k: dict(kinds.get(k, {"count": 0, "bytes": 0}))
          for k in placement.KINDS}
    st["total_bytes"] = sum(st[k]["bytes"] for k in placement.KINDS)
    st["total_count"] = sum(st[k]["count"] for k in placement.KINDS)
    st["coordinate"] = list(c) if c is not None else None
    return st


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             out_dir: Path) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    t0 = time.time()
    try:
        m = measure_cell(cfg, shape, mesh)
        low = m["lowered"]
        n = mesh.devices.size
        missing = set(np.ndindex(mesh.devices.shape)) - m["ran"]
        if missing:
            raise RuntimeError(f"{len(missing)} of {n} coordinates ran no "
                               f"program, e.g. {sorted(missing)[0]}")
        pc, peak = _largest(m["peak"])
        ac, arg = _largest(m["arguments"])
        fc, flops = _largest(m["flops"])
        rec.update({
            "status": "ok",
            "tp_strategy": low.rules.tp_strategy,
            "n_devices": n,
            "microbatches": low.model.cfg.microbatches,
            "microbatches_run": 1 if shape.kind == "train" else None,
            "run_s": round(time.time() - t0, 2),
            "flops_per_device": flops,
            "flops_coordinate": list(fc),
            "kernel_flops_per_device": m["kernel_flops"].get(fc, 0),
            "memory": {
                "argument_bytes": arg,
                "argument_coordinate": list(ac),
                "peak_bytes": peak,
                "peak_coordinate": list(pc),
                "peak_estimate_bytes": peak,
            },
            "collectives": _collective_summary(m["collectives"]),
            "kernel_calls": m["kernels"],
            "num_params": low.model.num_params(),
        })
        if shape.kind == "decode":
            rec["serving_kv"] = serving_kv_estimate(
                cfg, max_slots=shape.global_batch, max_len=shape.seq_len)
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    from repro_torch.launch.mesh import make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("pod16x16", make_production_mesh(
            multi_pod=False, devices=["meta"] * 256)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multipod2x16x16", make_production_mesh(
            multi_pod=True, devices=["meta"] * 512)))

    t0 = time.time()
    n_ok = n_skip = n_err = 0
    recs = _report(run_cell(arch, shape_name, mesh, mesh_name, out_dir)
                   for mesh_name, mesh in meshes for arch in archs
                   for shape_name in shapes)
    for rec in recs:
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_err += st == "error"
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors, {time.time() - t0:.1f} s")
    return 1 if n_err else 0


def _report(recs):
    """Print each record's line as it comes."""
    for rec in recs:
        where = f"{rec['mesh']:16s} {rec['arch']:22s} {rec['shape']:12s}"
        if rec["status"] == "ok":
            m = rec["memory"]["peak_bytes"] / 2**30
            print(f"[ok]   {where} {rec['tp_strategy']:10s} "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"mem/dev={m:.2f}GiB "
                  f"coll={rec['collectives']['total_bytes'] / 2**20:.1f}MiB "
                  f"run={rec['run_s']}s", flush=True)
        elif rec["status"] == "skipped":
            print(f"[skip] {where} {rec['reason'][:60]}", flush=True)
        else:
            print(f"[ERR]  {where} {rec['error'][:200]}", flush=True)
        yield rec


if __name__ == "__main__":
    raise SystemExit(main())
