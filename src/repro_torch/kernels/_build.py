"""Build and load the hand-written CUDA kernels.

Every ``kernels/<name>/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, and loaded with
``ctypes``; no PyTorch headers are included, so a build takes seconds.
Headers shared between kernels (``kernels/*.cuh``) are on the include
path.
Nothing is built at import time: the first launch builds every source at
once (one ``nvcc`` process each, all started together) into
``kernels/build/`` (listed in ``.gitignore``).  Libraries are named by a
hash of their source and the shared headers, so an edited source is
never served a stale build.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0 (a refused launch never runs, and
a later synchronize would not report it).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(KERNELS_DIR)]

_lock = threading.Lock()
_libs: dict = {}
BUILD_LOG: dict = {}   # name -> {"seconds", "ptxas"} of this process's builds
# the profiler range of an autograd Function's backward: this prefix and
# the wrapper's name
BACKWARD_RANGE = "train:backward:"


def sources() -> dict:
    """kernel name → its CUDA source, for every kernel in the package."""
    return {p.parent.parent.name: p
            for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def tool(name: str):
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``, ...), on
    the PATH or in the toolkit's ``bin/``; None where it is missing."""
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = tool("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of it and of the shared
    headers it may include."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(KERNELS_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every kernel source not yet built, all ``nvcc`` processes
    in parallel.  Returns {name: library path}; raises on a failed build."""
    srcs = sources()
    todo = {n: s for n, s in srcs.items() if not _lib_path(s).exists()}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name, src in todo.items():
            tmp = _lib_path(src).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        errors = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, _lib_path(todo[name]))
            BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                               "ptxas": out}
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {n: _lib_path(s) for n, s in srcs.items()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building on first use.
    ``signatures`` maps each C function to its ctypes argtypes (pointers
    and the stream as ``c_void_p``, so they are not cut to 32 bits)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def counted(wrapper):
    """Give a kernel wrapper its launch counters: ``.launches``, every
    launch of its kernel, ``.shapes``, a Counter of those launches by
    the wrapper's ``launch_key`` (what tells its launches apart), and
    ``.backwards``, the backwards its autograd Function ran."""
    wrapper.launches = 0
    wrapper.shapes = collections.Counter()
    wrapper.backwards = 0
    return wrapper


def count_launch(wrapper, key: tuple) -> None:
    """One launch of ``wrapper``'s kernel, at ``key``."""
    wrapper.launches += 1
    wrapper.shapes[key] += 1


@contextlib.contextmanager
def backward(wrapper):
    """One backward of ``wrapper``'s autograd Function: counted in
    ``wrapper.backwards`` and run under the profiler range
    ``BACKWARD_RANGE + wrapper.__name__``."""
    import torch
    wrapper.backwards += 1
    with torch.profiler.record_function(BACKWARD_RANGE + wrapper.__name__):
        yield


# the meter of the kernels' work on ``meta`` tensors: None, or a callable
# ``(wrapper name, flops, bytes, tensor)`` that the dry-run
# (:mod:`repro_torch.launch.dryrun`) installs; ``tensor`` is an input of
# the call, which tells the meter whose work it is
METER = None


def meta_call(wrapper, work, like, outs):
    """A wrapper's call on ``meta`` tensors: no kernel and no plain
    version runs; ``work`` (the kernel's (bytes, flops), from the
    wrapper's ``*_work`` function) goes to :data:`METER`, and ``outs``
    (empty tensors of the kernel's output shapes) are returned."""
    if METER is not None:
        nbytes, flops = work
        METER(wrapper.__name__, flops, nbytes, like)
    return outs


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def head_stride(t, dim: int, name: str) -> int:
    """The heads a row of ``t`` holds in memory along its heads dim
    ``dim``: ``t.shape[dim]`` where ``t`` is contiguous, more where it is
    a view of a contiguous tensor narrowed along ``dim`` (the run of KV
    heads a shard reads in place; its data pointer is then at the run's
    first head).  Raises for any other layout."""
    dim %= t.dim()
    if t.numel() == 0:
        return t.shape[dim]
    shape = list(t.shape)
    outer = [i for i in range(dim) if shape[i] > 1]
    inner = 1
    for size in shape[dim + 1:]:
        inner *= size
    S = shape[dim]
    if outer:
        between = 1
        for size in shape[outer[-1] + 1:dim]:
            between *= size
        S = t.stride(outer[-1]) // (between * inner)
    want, n = [0] * len(shape), 1
    for i in reversed(range(len(shape))):
        want[i] = n
        n *= S if i == dim else shape[i]
    if S < shape[dim] or any(shape[i] > 1 and t.stride(i) != want[i]
                             for i in range(len(shape))):
        raise ValueError(f"{name} must be contiguous, or a contiguous "
                         f"tensor narrowed along its heads (dim {dim})")
    return S
