"""Shared set-up of the port's parity tests: the same model and the same
parameters in the JAX package and in the port."""

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
