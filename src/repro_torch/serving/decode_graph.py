"""The engine's decode step as one CUDA graph.

The port's counterpart of the reference engine's jitted, donated decode
step (``jax.jit(_decode_paged_fn, donate_argnums=(1,))``): the engine runs
its first decode step eagerly (which loads, and if need be builds, the
kernel libraries), captures the same step once over static input buffers
and replays the graph every step after.  The step updates its cache in
place, so the graph writes into the engine's own cache tensors; their
addresses are recorded at capture and checked before every replay.

The kernel wrappers count their launches in Python, in all and by launch
key, which runs at capture and never at replay.  :class:`LaunchTally`
keeps the counters true: the capture counts nothing, and each replay adds
what one eager step counts.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch


def launch_counters() -> dict:
    """Every kernel wrapper of the port by name: each keeps its launch
    count in ``.launches``."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru import ops as lru_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"decode_attention": da_ops.decode_attention,
            "decode_attention_int8": da_ops.decode_attention_int8,
            "flash_attention": fa_ops.flash_attention,
            "rglru_scan": lru_ops.rglru_scan,
            "paged_decode_attention": pa_ops.paged_decode_attention,
            "ssd_chunk_scan": ssd_ops.ssd_chunked}


class LaunchTally:
    """Launch counts of one replay of a captured graph.  ``counters`` maps
    names to objects with a ``launches`` attribute (and, on the kernel
    wrappers, a ``shapes`` Counter of launches by launch key).  Around the
    capture (:meth:`capturing`) the counters are put back where they were
    and their increase is kept as the per-replay tally; :meth:`replayed`
    adds that tally."""

    def __init__(self, counters: dict):
        self.counters = counters
        self.per_replay: dict = {}
        self.per_replay_shapes: dict = {}

    @contextlib.contextmanager
    def capturing(self):
        before = {n: c.launches for n, c in self.counters.items()}
        shapes = {n: collections.Counter(c.shapes)
                  for n, c in self.counters.items() if hasattr(c, "shapes")}
        try:
            yield
        finally:
            self.per_replay = {n: c.launches - before[n]
                               for n, c in self.counters.items()
                               if c.launches != before[n]}
            self.per_replay_shapes = {
                n: self.counters[n].shapes - was for n, was in shapes.items()
                if self.counters[n].shapes != was}
            for n, c in self.counters.items():
                c.launches = before[n]
            for n, was in shapes.items():
                self.counters[n].shapes.clear()
                self.counters[n].shapes.update(was)

    def replayed(self):
        for n, k in self.per_replay.items():
            self.counters[n].launches += k
        for n, grew in self.per_replay_shapes.items():
            self.counters[n].shapes.update(grew)


def tensors(tree) -> list:
    """Every tensor in a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def leaf_ptrs(tree) -> list:
    """Data pointers of every tensor in ``tree``, in order."""
    return [t.data_ptr() for t in tensors(tree)]


class DecodeGraph:
    """One decode step captured as a CUDA graph.  ``step()`` runs the step
    over static input buffers and returns its logits; ``state()`` returns
    every tensor the step reads or writes in place (the cache or page pool
    and the input buffers), whose addresses must not change after
    capture.  The graph has its own memory pool, which holds one step's
    temporaries and the static logits."""

    def __init__(self, step, state, counters: dict | None = None):
        self._step = step
        self._state = state
        self.tally = LaunchTally(launch_counters() if counters is None
                                 else counters)
        self.graph = None
        self.logits = None
        self._ptrs = None
        self.replays = 0
        self.capture_ms = None

    def capture(self):
        """Capture the step.  Capturing launches nothing, so the engine's
        state is not stepped a second time.  A failure raises."""
        self._ptrs = leaf_ptrs(self._state())
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with self.tally.capturing(), torch.no_grad(), torch.cuda.graph(graph):
            self.logits = self._step()
        self.graph = graph
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def replay(self):
        """Run the captured step; → the static logits tensor, overwritten
        by the next replay."""
        if leaf_ptrs(self._state()) != self._ptrs:
            raise RuntimeError(
                "decode graph: a cache or input tensor moved since capture; "
                "replaying would read and write its old memory")
        self.graph.replay()
        self.tally.replayed()
        self.replays += 1
        return self.logits

    def stats(self) -> dict:
        return {"captures": int(self.graph is not None),
                "replays": self.replays,
                "launches_per_replay": dict(self.tally.per_replay),
                "capture_ms": self.capture_ms}
