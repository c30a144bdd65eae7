"""Nested dicts of tensors (the port's parameter and train-state trees),
flattened by ``/``-joined key path.

Keys are visited in sorted order at every level, the order in which
``jax.tree_util`` visits a dict's leaves, so a flat list of leaves lines
up with the reference's and a checkpoint's keys are the reference's.
"""

from __future__ import annotations


def flatten(tree, prefix="") -> dict:
    """{"a/b/c": leaf} of every leaf of a nested dict, in sorted key order.
    A bare leaf (a tree of one) flattens to {prefix: leaf}."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(like, flat: dict, prefix=""):
    """The nested dict of ``like``'s shape whose leaves are ``flat``'s."""
    if not isinstance(like, dict):
        return flat[prefix]
    return {k: unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same shape)."""
    if not isinstance(tree, dict):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
