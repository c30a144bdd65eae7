"""Seeded weights of a configuration, made by the benchmark on the device.

The tree has the layout the port's ``Model.schema()`` gives the dense and
MoE decoders (``layers/b0`` holds every layer stacked on a leading axis),
so the engine takes it as its parameters.  The values are the
benchmark's own: one flat buffer in the served type, filled by a few
large ``normal_`` calls of one ``torch.Generator`` on the device, then
scaled leaf by leaf (matrices by 1/sqrt(fan-in), the embedding by 0.02,
norm scales and biases by 0.1 around their neutral value).  The same
seed on the same device gives the same weights, so the reference makes
them again after the window instead of reading the program's.

Imports nothing of the port.
"""

from __future__ import annotations

import math

import torch

# elements per normal_ call: a few large calls, each under 2**31
CHUNK = 1 << 30


def leaf_specs(run: dict) -> dict:
    """{path: (shape, kind, fan_in)} of every leaf, ``path`` a tuple of
    keys; kind is ``matrix``, ``embed``, ``scale_one`` (a layer-norm
    scale, neutral at 1), ``scale_zero`` (an RMS-norm or qk-norm scale,
    applied as 1 + scale) or ``bias``."""
    L, D = run["num_layers"], run["d_model"]
    H, KVH, hd = run["num_heads"], run["num_kv_heads"], run["head_dim"]
    F, V = run["d_ff"], run["vocab_padded"]
    out = {}

    def norm(prefix, lead=()):
        if run["norm_type"] == "layernorm":
            out[prefix + ("scale",)] = (lead + (D,), "scale_one", 0)
            out[prefix + ("bias",)] = (lead + (D,), "bias", 0)
        else:
            out[prefix + ("scale",)] = (lead + (D,), "scale_zero", 0)

    out[("embed",)] = ((V, D), "embed", 0)
    norm(("final_norm",))
    if not run["tie_embeddings"]:
        out[("lm_head",)] = ((D, V), "matrix", D)
    b = ("layers", "b0")
    norm(b + ("ln1",), (L,))
    norm(b + ("ln2",), (L,))
    a = b + ("attn",)
    out[a + ("wq",)] = ((L, D, H, hd), "matrix", D)
    out[a + ("wk",)] = ((L, D, KVH, hd), "matrix", D)
    out[a + ("wv",)] = ((L, D, KVH, hd), "matrix", D)
    out[a + ("wo",)] = ((L, H, hd, D), "matrix", H * hd)
    if run["qkv_bias"]:
        out[a + ("bq",)] = ((L, H, hd), "bias", 0)
        out[a + ("bk",)] = ((L, KVH, hd), "bias", 0)
        out[a + ("bv",)] = ((L, KVH, hd), "bias", 0)
    if run["qk_norm"]:
        out[a + ("q_norm",)] = ((L, hd), "scale_zero", 0)
        out[a + ("k_norm",)] = ((L, hd), "scale_zero", 0)
    if run["family"] == "moe":
        E = run["num_experts"]
        m = b + ("moe",)
        out[m + ("router",)] = ((L, D, E), "matrix", D)
        out[m + ("w_gate",)] = ((L, E, D, F), "matrix", D)
        out[m + ("w_up",)] = ((L, E, D, F), "matrix", D)
        out[m + ("w_down",)] = ((L, E, F, D), "matrix", F)
    elif run["family"] == "dense":
        m = b + ("mlp",)
        out[m + ("w_gate",)] = ((L, D, F), "matrix", D)
        out[m + ("w_up",)] = ((L, D, F), "matrix", D)
        out[m + ("w_down",)] = ((L, F, D), "matrix", F)
    else:
        raise ValueError(f"family {run['family']!r}: dense or moe")
    return out


def make_weights(run: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The seeded parameter tree on ``device`` in ``dtype``: nested dicts
    whose leaves are views of one flat buffer."""
    specs = leaf_specs(run)
    total = sum(math.prod(s) for s, _, _ in specs.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    flat = torch.empty(total, dtype=dtype, device=device)
    with torch.no_grad():
        for a in range(0, total, CHUNK):
            flat[a:a + CHUNK].normal_(generator=gen)
        tree, at = {}, 0
        for path in sorted(specs):
            shape, kind, fan_in = specs[path]
            n = math.prod(shape)
            leaf = flat[at:at + n].view(shape)
            at += n
            if kind == "matrix":
                leaf.mul_(1.0 / math.sqrt(fan_in))
            elif kind == "embed":
                leaf.mul_(0.02)
            elif kind == "scale_one":
                leaf.mul_(0.1).add_(1.0)
            else:                       # scale_zero, bias
                leaf.mul_(0.1)
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
    return tree


def layer(tree: dict, i: int, dtype=torch.float32) -> dict:
    """Layer ``i`` of the stacked ``layers/b0`` subtree, in ``dtype``."""
    def pick(node):
        return {k: pick(v) if isinstance(v, dict) else v[i].to(dtype)
                for k, v in node.items()}
    return pick(tree["layers"]["b0"])
