"""Parameter bridge between the JAX reference and the port.

The reference seeds its init from ``hash(path)``, which Python randomizes
per process, so the two packages can only be compared on the *same*
parameters: the tests initialize with JAX, hand the tree over as numpy
arrays, and convert it here.  The trees have the same nesting and leaf
shapes (including the stacked ``layers`` axis, or the encoder-decoder's
``enc_layers``/``dec_layers``), so the conversion is
leaf by leaf and exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def from_jax(cfg, params_np, *, device="cuda", dtype=None) -> dict:
    """Nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``)
    → nested dict of tensors on ``device``.  ``dtype`` casts every leaf;
    by default each keeps its own type, so the round trip is bit for bit."""
    dev = resolve_device(device)
    unstacked = ("layers" in params_np and "b0" not in params_np["layers"]) \
        or any("g0" in params_np.get(k, {})
               for k in ("enc_layers", "dec_layers"))
    if unstacked:
        raise ValueError(
            f"{cfg.name}: only scan_layers=True trees (stacked 'layers/b0', "
            f"'enc_layers', 'dec_layers') are supported")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":  # ml_dtypes: go through float32
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)   # a copy: the caller's arrays stay its own
        return t.to(device=dev, dtype=dtype or t.dtype)
    return conv(params_np)


def to_numpy(params) -> dict:
    """Nested dict of tensors → nested dict of numpy arrays (float32 for
    bfloat16 leaves, which numpy has no type for)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return conv(params)
