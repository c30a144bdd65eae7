"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

Counterpart of ``repro/sharding/rules.py``: the same rules, strategies and
fallbacks, resolved to the same layouts.  A spec is a tuple with one entry
per dim: ``None`` (replicated), a mesh axis name, or a tuple of names (the
content of the reference's ``PartitionSpec``).  A mesh is
:class:`repro_torch.launch.mesh.Mesh` (anything with ``axis_names`` and
``devices.shape`` resolves).

Mesh axes: single-pod ``("data","model")`` = (16,16); multi-pod
``("pod","data","model")`` = (2,16,16) — ``pod`` is pure data parallelism
(only gradient reductions cross it).

Two tensor-parallel strategies, chosen per architecture (``auto``):

* ``heads``   — attention heads sharded over ``model`` (classic Megatron
  attention).  Used when num_heads divides the model-axis size; KV heads
  shard too when divisible, else replicate (GQA kv=8 on 16-way TP).
* ``ulysses`` — q/k/v activations shard the *sequence* over ``model``
  (DeepSpeed-Ulysses-style): works for any head count (40, 56, …); weights
  still shard their fused head dim.  KV is gathered per chip.

MLP/vocab/expert dims always shard over ``model``; the remaining weight dim
shards over ``data`` (FSDP/ZeRO-3: gather on use, reduce-scatter grads).
Any non-divisible (dim, axis) pair falls back to replication for that dim.

Where the reference hands activation rules to GSPMD
(``with_sharding_constraint``), the port's tensor-parallel model code
computes in that layout itself; :func:`constrain_activation` holds the two
equal under :class:`use_rules`.
"""

from __future__ import annotations

import contextvars
from dataclasses import dataclass


@dataclass
class ShardingRules:
    mesh: object                # launch.mesh.Mesh (or any object with
                                #  axis_names and devices.shape)
    tp_strategy: str            # heads | ulysses
    param_rules: dict
    act_rules: dict

    @property
    def dp_axes(self):
        names = self.mesh.axis_names
        return tuple(a for a in ("pod", "data") if a in names)


_active: contextvars.ContextVar[ShardingRules | None] = \
    contextvars.ContextVar("sharding_rules", default=None)


def _dp(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def make_rules(mesh, cfg) -> ShardingRules:
    model_size = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
    strategy = cfg.tp_strategy
    if strategy == "auto":
        heads_ok = (cfg.num_heads or 0) % model_size == 0 and cfg.num_heads
        # ulysses_sp (sequence-parallel residual) over plain ulysses: the
        # reference's choice for its training mesh
        strategy = "heads" if heads_ok or cfg.family == "ssm" \
            else "ulysses_sp"
    dp = _dp(mesh)

    # ZeRO-2: weights replicate over the data axis (TP sharding over model
    # retained) so microbatched steps don't re-gather weights per
    # microbatch; only optimizer moments shard over data
    # (opt_state_pspecs below always uses the fsdp layout for moments).
    wdata = ("data",) if cfg.param_strategy not in (
        "zero2", "zero2_master") else None
    param_rules = {
        "vocab": ("model",),
        "embed": wdata,
        "ffn": ("model",),
        "heads": ("model",) if strategy == "heads" else None,
        "kv_heads": ("model",) if strategy == "heads" else None,
        "head_dim": None if strategy == "heads" else ("model",),
        "experts": ("model",),
        "moe_ffn": None,
        "experts_router": None,
        "lru": ("model",),
        "lru_in": wdata,
        "inner": ("model",),
        "inner_fused": ("model",),
        "ssm_heads": None,
        "conv": None,
        "layers": None,
    }

    # expert buffers [E, C, D]: experts over model (EP); the capacity dim
    # C stays local (the reference's layout)
    if strategy == "heads":
        act_rules = {
            "act_hidden": (dp, None, None),
            "act_qkv": (dp, None, "model", None),
            "act_kv": (dp, None, "model", None),
            "act_ffn": (dp, None, "model"),
            "act_logits": (dp, None, "model"),
            "act_expert": ("model", None, None),
            "act_expert_ffn": ("model", None, None),
            "act_moe_group": (dp, None, None),
            "act_expert_grouped": (dp, "model", None, None),
            "act_lru": (dp, None, "model"),
            "act_ssm": (dp, None, "model", None),
        }
    elif strategy == "heads_sp":
        # heads-sharded attention + sequence-parallel residual stream
        act_rules = {
            "act_hidden": (dp, "model", None),
            "act_qkv": (dp, None, "model", None),
            "act_kv": (dp, None, "model", None),
            "act_ffn": (dp, None, "model"),
            # logits stay vocab-sharded: seq-sharding them would fall back
            # to None at decode (seq=1) and replicate the whole lm_head
            "act_logits": (dp, None, "model"),
            "act_expert": ("model", None, None),
            "act_expert_ffn": ("model", None, None),
            "act_moe_group": (dp, None, None),
            "act_expert_grouped": (dp, "model", None, None),
            "act_lru": (dp, None, "model"),
            "act_ssm": (dp, None, "model", None),
        }
    elif strategy == "ulysses":  # sequence over model inside attention
        act_rules = {
            "act_hidden": (dp, None, None),
            "act_qkv": (dp, "model", None, None),
            "act_kv": (dp, None, None, None),
            "act_ffn": (dp, None, "model"),
            "act_logits": (dp, None, "model"),
            "act_expert": ("model", None, None),
            "act_expert_ffn": ("model", None, None),
            "act_moe_group": (dp, None, None),
            "act_expert_grouped": (dp, "model", None, None),
            "act_lru": (dp, None, "model"),
            "act_ssm": (dp, None, "model", None),
        }
    else:  # ulysses_sp: + Megatron-style sequence parallelism — the
        # residual stream stays sequence-sharded over `model` between
        # layers, so norms/elementwise are local and boundary collectives
        # move bf16 seq-shards instead of re-gathering the full hidden
        act_rules = {
            "act_hidden": (dp, "model", None),
            "act_qkv": (dp, "model", None, None),
            "act_kv": (dp, None, None, None),
            "act_ffn": (dp, "model", None),
            # vocab-sharded (see heads_sp note)
            "act_logits": (dp, None, "model"),
            "act_expert": ("model", None, None),
            "act_expert_ffn": ("model", None, None),
            "act_lru": (dp, "model", None),
            "act_ssm": (dp, "model", None, None),
        }
    return ShardingRules(mesh, strategy, param_rules, act_rules)


def make_serving_rules(mesh, cfg) -> ShardingRules:
    """Serving-time rules: tensor parallelism over ``model``, forced to the
    ``heads`` strategy.

    Decode works on a sequence of length 1, so the ulysses layouts (which
    shard the *sequence* over ``model``) degenerate to full replication via
    the divisibility fallback — every device would recompute the whole
    attention.  ``heads`` shards q/k/v heads and the paged KV pool instead,
    which is the layout the fleet's per-replica meshes want.  Head counts
    that don't divide ``tp`` fall back to replication per-dim as usual.
    """
    return make_rules(mesh, cfg.replace(tp_strategy="heads"))


class use_rules:
    def __init__(self, rules: ShardingRules | None):
        self.rules = rules

    def __enter__(self):
        self._tok = _active.set(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _active.reset(self._tok)
        return False


def active_rules() -> ShardingRules | None:
    return _active.get()


# ---------------------------------------------------------------------------
# resolution with divisibility fallback


def _axis_sizes(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _fit(dim_size, axes, sizes):
    """Return axes if dim_size divides their product, else None."""
    if axes is None:
        return None
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    total = 1
    for a in axes:
        if a not in sizes:
            return None
        total *= sizes[a]
    if dim_size % total != 0 or dim_size < total:
        return None
    return axes if len(axes) > 1 else axes[0]


def param_pspec(rules: ShardingRules, logical_axes, shape) -> tuple:
    sizes = _axis_sizes(rules.mesh)
    used = set()
    out = []
    for dim, name in zip(shape, logical_axes):
        axes = rules.param_rules.get(name)
        fit = _fit(dim, axes, sizes)
        if fit is None:
            out.append(None)
            continue
        flat = (fit,) if isinstance(fit, str) else fit
        if any(a in used for a in flat):
            out.append(None)
            continue
        used.update(flat)
        out.append(fit)
    return tuple(out)


def act_pspec(rules: ShardingRules, name, shape) -> tuple | None:
    spec = rules.act_rules.get(name)
    if spec is None:
        return None
    sizes = _axis_sizes(rules.mesh)
    out = []
    used = set()
    for dim, axes in zip(shape, spec):
        fit = _fit(dim, axes, sizes)
        if fit is None:
            out.append(None)
            continue
        flat = (fit,) if isinstance(fit, str) else fit
        if any(a in used for a in flat):
            out.append(None)
            continue
        used.update(flat)
        out.append(fit)
    return tuple(out)


def constrain_activation(name: str, shape, local_shapes):
    """Hold the layout the tensor-parallel model code computes activation
    ``name`` in against its rule.  The port has no GSPMD to hand the rule
    to: an activation rule documents the layout, and under
    :class:`use_rules` this check raises where the shards' shapes
    (``local_shapes``, one per rank along ``model``) are not ``shape``
    split by :func:`act_pspec`.  Without active rules it does nothing."""
    rules = _active.get()
    if rules is None:
        return
    spec = act_pspec(rules, name, shape)
    if spec is None:
        return
    sizes = _axis_sizes(rules.mesh)
    want = tuple(local_shape(shape, spec, sizes, ("model",)))
    for got in local_shapes:
        if tuple(got) != want:
            raise ValueError(f"activation {name!r} {tuple(shape)}: a shard "
                             f"of {tuple(got)}, its rule {spec} gives "
                             f"{want}")


def local_shape(shape, spec, sizes, axes=None):
    """The shape of one shard of a ``shape`` tensor laid out by ``spec``,
    splitting only over ``axes`` (default: every mesh axis)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            if axes is None or a in axes:
                n *= sizes[a]
        out.append(dim // n)
    return out


# ---------------------------------------------------------------------------
# pytree spec builders


def params_pspecs(rules: ShardingRules, model) -> dict:
    return _map2(lambda a, s: param_pspec(rules, a, s.shape),
                 model.param_logical_axes(), model.abstract_params())


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def opt_state_pspecs(rules: ShardingRules, model) -> dict:
    """Optimizer-moment sharding: always the FSDP (data-sharded) layout —
    under ZeRO-2 the moments stay sharded even though weights replicate."""
    if rules.mesh is None:  # pragma: no cover
        return params_pspecs(rules, model)
    shadow = make_rules(rules.mesh,
                        model.cfg.replace(param_strategy="fsdp"))
    return params_pspecs(shadow, model)


def _cache_leaf_pspec(rules: ShardingRules, path: str, shape,
                      layout: str = "contiguous") -> tuple:
    """Cache sharding by leaf name:

    Contiguous KV caches [.., B, C, KVH, hd]: batch → dp; heads → model when
    divisible, else the *sequence* dim shards over model (flash-decoding
    style partial attention — XLA inserts the small partial-softmax
    reductions).
    Paged KV pools [.., P, ps, KVH, hd]: only the head dim shards (over
    model, when divisible) — page and in-page dims stay replicated because
    page ids are a single global namespace shared by every slot's page
    table; splitting pages across devices would turn the allocator's
    refcounted free list into a distributed one.  Page tables (plain int32
    host arrays) never reach this function.
    Recurrent states: width/head dims over model.
    """
    sizes = _axis_sizes(rules.mesh)
    dp = rules.dp_axes
    leaf = path.split("/")[-1]
    nd = len(shape)
    spec = [None] * nd
    if layout == "paged" and leaf in ("k", "v"):
        kvh = nd - 2
        if _fit(shape[kvh], ("model",), sizes):
            spec[kvh] = "model"
    elif leaf in ("k", "v", "cross_k", "cross_v"):
        b, c, kvh = nd - 4, nd - 3, nd - 2
        spec[b] = _fit(shape[b], dp, sizes)
        if _fit(shape[kvh], ("model",), sizes):
            spec[kvh] = "model"
        else:
            spec[c] = _fit(shape[c], ("model",), sizes)
    elif leaf in ("k_scale", "v_scale"):   # [.., B, C, KVH]
        b, c, kvh = nd - 3, nd - 2, nd - 1
        spec[b] = _fit(shape[b], dp, sizes)
        if _fit(shape[kvh], ("model",), sizes):
            spec[kvh] = "model"
        else:
            spec[c] = _fit(shape[c], ("model",), sizes)
    elif leaf == "h":      # rglru state [.., B, W]
        spec[nd - 2] = _fit(shape[nd - 2], dp, sizes)
        spec[nd - 1] = _fit(shape[nd - 1], ("model",), sizes)
    elif leaf == "conv":   # [.., B, K-1, W]
        spec[nd - 3] = _fit(shape[nd - 3], dp, sizes)
        spec[nd - 1] = _fit(shape[nd - 1], ("model",), sizes)
    elif leaf == "ssm":    # [.., B, H, P, N]
        spec[nd - 4] = _fit(shape[nd - 4], dp, sizes)
        spec[nd - 3] = _fit(shape[nd - 3], ("model",), sizes)
    return tuple(spec)


def cache_pspecs(rules: ShardingRules, cache_abstract,
                 layout: str = "contiguous") -> dict:
    """The spec of every leaf of a cache tree (nested dicts of tensors,
    real or ``meta``), by its path."""
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")

    def go(tree, path):
        if isinstance(tree, dict):
            return {k: go(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        return _cache_leaf_pspec(rules, path, tree.shape, layout)
    return go(cache_abstract, "")


def batch_pspecs(rules: ShardingRules, batch_abstract) -> dict:
    """Token/target/frame inputs: batch dim → dp, rest replicated."""
    sizes = _axis_sizes(rules.mesh)
    dp = rules.dp_axes

    def go(leaf):
        if isinstance(leaf, dict):
            return {k: go(v) for k, v in leaf.items()}
        spec = [None] * len(leaf.shape)
        if leaf.shape:
            spec[0] = _fit(leaf.shape[0], dp, sizes)
        return tuple(spec)

    return go(batch_abstract)
