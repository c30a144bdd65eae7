"""Shared set-up of the port's parity tests: the same model and the same
parameters in the JAX package and in the port."""

import importlib
import importlib.util
import itertools
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as get_config_jax
from repro.models import build_model as build_jax
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import to_numpy

# recurrentgemma-9b.reduced() cut to one (rglru, rglru, attn) super-block
# plus a two-block rglru tail, with a window of 8 slots
HYBRID = dict(num_layers=5, attn_window=8)


def build_pair(name, seed=3, **replace):
    """(cfg, JAX model, JAX params, port model, port params) on the same
    parameters.  They come from the port's seeded init and go to JAX as
    numpy arrays: the reference's init seeds from ``hash(path)``, which
    changes per process, and with int8 KV a last-bit difference can round
    a value the other way, so only fixed parameters make a run
    repeatable."""
    cfg_j = get_config_jax(name).reduced().replace(**replace)
    cfg_t = get_config(name).reduced().replace(**replace)
    mj, mt = build_jax(cfg_j), build_model(cfg_t)
    params_t = mt.init(seed, device="cpu")
    params_j = jax.tree.map(jnp.asarray, to_numpy(params_t))
    assert jax.tree.structure(params_j) == jax.tree.structure(
        mj.abstract_params())
    assert all(isinstance(v, torch.Tensor)
               for v in jax.tree.leaves(params_t))
    return cfg_t, mj, params_j, mt, params_t


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


CACHE_TOL = 1e-4


def assert_cache_close(cache_t, cache_j):
    """Every leaf of the port's grouped cache against the reference's, of
    the same shape, at CACHE_TOL relative and absolute; int8 leaves to one
    quantization step in under 1% of entries (K/V that differ in the last
    float32 bits can round the other way at a tie)."""
    flat_j = dict(_leaves(jax.tree.map(np.asarray, cache_j)))
    flat_t = dict(_leaves(cache_t))
    assert flat_t.keys() == flat_j.keys()
    for path, a in flat_j.items():
        b = flat_t[path]
        assert tuple(b.shape) == a.shape, path
        if a.dtype == np.int8:
            diff = np.abs(b.numpy().astype(np.int32) - a.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, path
        else:
            np.testing.assert_allclose(b.float().numpy(), a, rtol=CACHE_TOL,
                                       atol=CACHE_TOL, err_msg=str(path))


# the serving scenarios both engines run on reduced stablelm-3b

def _rand_prompts(seed, n, length, lo=1, hi=200):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(lo, hi, size=length)]
            for _ in range(n)]


PREFIX = list(range(40, 72))   # page-aligned 32-token shared prefix

# name -> (engine kwargs, prompts, max_new, warm prefix)
SCENARIOS = {
    "single": (dict(max_slots=4, max_len=64), [[5, 17, 31]], 8, None),
    "concurrent": (dict(max_slots=4, max_len=64),
                   [[1, 2, 3], [9, 8, 7], [42, 5, 6], [3, 1, 4]], 4, None),
    "more_than_slots": (dict(max_slots=2, max_len=64),
                        [[i, i + 1] for i in range(5)], 4, None),
    "shared_prefix": (dict(max_slots=4, max_len=96),
                      [PREFIX + [100 + i, 7, 9 + i] for i in range(3)], 6,
                      PREFIX),
    "chunked": (dict(max_slots=2, max_len=64, prefill_chunk=8),
                [list(range(3, 23)), list(range(50, 80))], 5, None),
    "backpressure": (dict(max_slots=4, max_len=64, page_size=16,
                          num_pages=8), _rand_prompts(3, 4, 40), 8, None),
}


# the PopPy corpus, loaded under either package

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("repro", "repro_torch")
CORPUS = {name: ROOT / "benchmarks" / "apps" / f"{name}.py"
          for name in ("tot", "sot", "dae", "bird", "traq", "camel")}
CORPUS["quickstart"] = ROOT / "examples" / "quickstart.py"
CORPUS["multi_agent_debate"] = ROOT / "examples" / "multi_agent_debate.py"
CORPUS["core_programs"] = ROOT / "tests" / "torch_core_programs.py"
_loaded = itertools.count()


def load_under(package, path, tmp_path):
    """The module at ``path`` with its ``repro.core`` and
    ``repro.durability`` imports pointed at ``package`` (``"repro"`` or
    ``"repro_torch"``), imported fresh under a unique name from a copy
    under ``tmp_path``: ``@poppy`` reads its programs' source from their
    file, and a process-offloaded external is imported by module name in
    the worker, so the copy is a file and sits in ``sys.modules``."""
    src = pathlib.Path(path).read_text()
    if package == "repro_torch":
        src = re.sub(r"\brepro\.(core|durability)\b", r"repro_torch.\1", src)
    elif package != "repro":
        raise ValueError(f"unknown package {package!r}")
    name = f"_corpus_{package}_{pathlib.Path(path).stem}_{next(_loaded)}"
    file = tmp_path / f"{name}.py"
    file.write_text(src)
    spec = importlib.util.spec_from_file_location(name, file)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def core_of(package):
    """``(core, ai, durability)`` of ``package``."""
    return tuple(importlib.import_module(f"{package}.{m}")
                 for m in ("core", "core.ai", "durability"))


def poppy_functions(mod):
    """Every ``@poppy`` function a corpus module defines, by name (camel's
    programs by their key)."""
    fns = {name: v for name, v in vars(mod).items()
           if type(v).__name__ == "PoppyFn"}
    fns.update(getattr(mod, "PROGRAMS", {}))
    return fns
