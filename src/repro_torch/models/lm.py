"""Decoder-only language model: the dense attention family, the MoE
family, the VLM (a dense decoder whose prompt may start with patch
embeddings), the hybrid RG-LRU/local-attention family and the Mamba-2
SSM family.  The encoder-decoder family is :mod:`.encdec`.

Counterpart of ``repro/models/lm.py``.  Parameters keep the reference's
layer grouping: ``layers/b{i}`` holds the stacked ``[n_groups, ...]``
leaves of the i-th block of the repeating pattern (the reference's
``lax.scan`` super-blocks, e.g. RecurrentGemma's (rglru, rglru, attn)),
and ``tail{i}`` the unrolled remainder blocks; layers run in a Python loop
in that order.

Tensor parallelism: given :class:`~repro_torch.sharding.placement.
ShardedParams` (parameters laid out on a mesh's ``model`` axis by the
serving rules), :func:`prefill`, :func:`decode_step` and
:func:`decode_step_paged` run the sharded program of every decoder-only
family: every shard runs its own q heads through the attention kernels,
its slice of the MLP's hidden dim, its experts (MoE, the ``shard_map``
dispatch), its RG-LRU channels and its SSD heads; the row-parallel
products (``wo``, the down projections, the recurrent blocks' output
projections) are partial sums that one
:func:`~repro_torch.sharding.placement.reduce_sum` adds up; the
embedding is a masked lookup of each shard's vocab rows plus a
reduce_sum, and the logits are the shards' vocab slices concatenated.
Where a dim falls back to replication, every shard holds the whole
product and nothing is summed.  A mesh whose data axes exceed 1 runs
this program once a data coordinate, on its slice of the batch, each
leaf gathered over the data axes for use (FSDP; :class:`~repro_torch.
sharding.placement.RowParams` for inference, :func:`forward_tp` and
:func:`mesh_layer` for training, where one backward reduce-scatters
every row's gradients).  The strategies other than ``heads`` split a
row's sequence over its shards where the rules say so (:data:`LAYOUTS`,
:func:`mesh_block`): ``ulysses_sp`` (heads that do not split the model
axis) keeps the residual stream split by sequence and runs each shard's
rows through whole gathered attention and MLP weights
(:func:`rows_attention`), ``ulysses`` splits only the attention's
queries, ``heads_sp`` only the residual stream; the recurrent mixers and
the MoE layer gather the sequence and run the heads layout; a sequence
the shard count does not divide is whole on every shard, and a decode
step of one token replicates, as the reference's fallback does.  Under
``heads`` the residual stream, the norms and the
sampling stay replicated: computed once, on shard 0's device.  The
cache is one tree per shard under :func:`shard_key`, each laid out as
the serving rules' ``cache_pspecs`` say: a contiguous K/V cache whose KV
heads do not split (recurrentgemma's one KV head) is split by sequence
where its slots divide the shard count, and its decode merges the
shards' partial attentions; where they do not, every shard holds the
whole cache, as it holds every replicated leaf (:class:`TensorParallel`).

Two cache layouts:
- the **paged** and **prefix-aware** path of the attention-only families
  (dense, MoE and VLM; the default engine path) keeps flat ``{"k", "v"}``
  leaves: ``[L, B, T, KVH, hd]`` from :func:`prefill`, pools ``[L, P,
  ps, KVH, hd]``;
- the **contiguous** path (SSM, hybrid, int8-KV and windowed models,
  whose state cannot be cut by position) keeps the reference's grouped tree
  (:func:`init_cache`): ``{"layers": {"b{i}": leaves [n_groups, B, ...]},
  "tail{i}": leaves [B, ...]}``, with windowed attention in ring buffers
  of ``min(capacity, window)`` slots.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.sharding.placement import (
    NamedSharding,
    ShardedParams,
    ShardedTensor,
    all_gather,
    broadcast,
    data_rows,
    drop_axes,
    gather,
    gather_axes,
    get_path,
    leaf_paths,
    local_zeros,
    mesh_gather,
    on_row,
    reduce_max,
    reduce_sum,
    set_path,
    shard_slices,
)
from repro_torch.sharding.rules import (
    cache_pspecs,
    constrain_activation,
    make_serving_rules,
)

from . import attention as att
from . import mlp as mlpmod
from . import moe as moemod
from . import rglru as rgmod
from . import ssd as ssdmod
from .common import (
    PSpec,
    apply_norm,
    apply_rope,
    norm_schema,
    remat,
    rope_cos_sin,
    stack_schema,
)

# families whose every block is global attention plus a feed-forward
ATTENTION_ONLY = ("dense", "moe", "vlm")


def check_family(cfg):
    """This module runs the decoder-only families; the encoder-decoder
    family runs in :mod:`.encdec`, and any other family raises."""
    if cfg.family not in ATTENTION_ONLY + ("hybrid", "ssm"):
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r} has no decoder-only LM"
            + (" (encoder-decoder models run in models.encdec)"
               if cfg.family == "enc_dec" else ""))


def is_contiguous(cfg) -> bool:
    """True when the serving cache cannot be cut by position (recurrent
    state, ring buffers, int8 KV): such models use the grouped contiguous
    cache and exact-length prefill."""
    return (cfg.family not in ATTENTION_ONLY
            or cfg.kv_cache_dtype == "int8" or bool(cfg.attn_window))


# ---------------------------------------------------------------------------
# layer grouping and schemas


def block_kinds(cfg) -> list:
    """The per-layer block kinds, in order."""
    check_family(cfg)
    if cfg.family in ("dense", "vlm"):
        return ["attn_mlp"] * cfg.num_layers
    if cfg.family == "moe":
        return ["attn_moe"] * cfg.num_layers
    if cfg.family == "ssm":
        return ["ssd"] * cfg.num_layers
    pat = list(cfg.block_pattern)
    kinds = []
    while len(kinds) < cfg.num_layers:
        kinds.extend(pat)
    return [("rglru_mlp" if k == "rglru" else "attn_mlp_local")
            for k in kinds[:cfg.num_layers]]


def _layer_groups(cfg):
    """(group_kinds, n_groups, tail_kinds): n_groups super-blocks of
    group_kinds, then the unrolled tail_kinds."""
    kinds = block_kinds(cfg)
    if cfg.family == "hybrid":
        pat_len = len(cfg.block_pattern)
        n_groups = cfg.num_layers // pat_len
        return kinds[:pat_len], n_groups, kinds[n_groups * pat_len:]
    return [kinds[0]], cfg.num_layers, []


def block_schema(cfg, kind: str) -> dict:
    if kind in ("attn_mlp", "attn_mlp_local"):
        return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
                "ln2": norm_schema(cfg), "mlp": mlpmod.mlp_schema(cfg)}
    if kind == "attn_moe":
        return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
                "ln2": norm_schema(cfg), "moe": moemod.moe_schema(cfg)}
    if kind == "rglru_mlp":
        return {"ln1": norm_schema(cfg), "rglru": rgmod.rglru_schema(cfg),
                "ln2": norm_schema(cfg), "mlp": mlpmod.mlp_schema(cfg)}
    if kind == "ssd":   # pre-norm only: no MLP after the mixer
        return {"ln1": norm_schema(cfg), "ssd": ssdmod.ssd_schema(cfg)}
    raise ValueError(kind)


def lm_schema(cfg) -> dict:
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    V, D = cfg.vocab_padded, cfg.d_model
    group = {f"b{i}": block_schema(cfg, k) for i, k in enumerate(group_kinds)}
    s = {
        "embed": PSpec((V, D), "embed", axes=("vocab", "embed")),
        "final_norm": norm_schema(cfg),
        "layers": stack_schema(group, n_groups),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = PSpec((D, V), axes=("embed", "vocab"))
    for i, k in enumerate(tail_kinds):
        s[f"tail{i}"] = block_schema(cfg, k)
    return s


def unstack(tree, n):
    """The n layers of a stacked subtree (leaves ``[n, ...]``), as views
    that one ``unbind`` a leaf makes (so an in-place cache update writes
    through); in training its backward stacks the layers' gradients in
    one op, where indexing layer by layer would allocate a full-size
    gradient for every layer."""
    per_leaf = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def blocks(cfg, tree):
    """(kind, subtree) of every layer in order, where ``tree`` is the
    parameter tree or a grouped cache: layer g·P + i of the super-blocks
    reads ``tree["layers"]["b{i}"]`` at index g, then the tail blocks."""
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    out = [(kind, gp[f"b{i}"])
           for gp in unstack(tree["layers"], n_groups)
           for i, kind in enumerate(group_kinds)]
    for i, kind in enumerate(tail_kinds):
        out.append((kind, tree[f"tail{i}"]))
    return out


# ---------------------------------------------------------------------------
# embeddings and logits


def embed_inputs(cfg, params, batch):
    """Token embeddings and positions.  A ``patch_stub`` model (the VLM)
    given ``batch["patch_embeds"]`` [B, n, D] takes them in place of the
    first n token embeddings; positions stay 0 … S-1."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    if cfg.frontend == "patch_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :].repeat(B, 1)
    return h, positions


def mask_vocab_padding(cfg, logits):
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    return torch.where(pad, logits, torch.full((), -1e30, dtype=logits.dtype,
                                               device=logits.device))


def logits_from_hidden(cfg, params, h):
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = h @ params["lm_head"].to(h.dtype)
    return mask_vocab_padding(cfg, logits)


# ---------------------------------------------------------------------------
# full sequence (forward and prefill)


def _window(cfg, kind):
    return cfg.attn_window if kind == "attn_mlp_local" else 0


# recurrent block kinds → (parameter subtree, full-sequence function)
_RECURRENT = {"rglru_mlp": ("rglru", rgmod.apply_rglru),
              "ssd": ("ssd", ssdmod.apply_ssd)}


def feed_forward(cfg, kind, p, h):
    """The block's second half: h + FFN(norm(h)) → (h, the MoE layer's
    Switch aux loss, or None for an MLP)."""
    x = apply_norm(cfg, p["ln2"], h)
    if kind == "attn_moe":
        m, aux = moemod.apply_moe(cfg, p["moe"], x)
        return h + m, aux
    return h + mlpmod.apply_mlp(cfg, p["mlp"], x), None


def apply_block(cfg, kind, p, h, positions, *, fill=None, return_kv=False,
                prefix_kv=None, prefix_len=0):
    """One block over a full sequence → (h, cache, aux).  With ``fill`` (a
    cache capacity) the cache is the block's decode cache: packed K/V
    placed in ``min(fill, window)`` slots for attention, the final state
    for RG-LRU and SSD.  With ``return_kv`` it is an attention block's raw
    (k, v); ``prefix_kv``/``prefix_len`` are prefix-aware prefill's
    (see :func:`att.full_attention`).  Otherwise it is None.  ``aux`` is
    an MoE block's Switch aux loss, else None."""
    x = apply_norm(cfg, p["ln1"], h)
    cache = None
    if kind in _RECURRENT:
        name, apply = _RECURRENT[kind]
        out = apply(cfg, p[name], x, return_state=fill is not None)
        mix, cache = out if fill is not None else (out, None)
    else:
        window = _window(cfg, kind)
        mix, kv = att.full_attention(
            cfg, p["attn"], x, positions=positions, window=window,
            return_kv=True, prefix_kv=prefix_kv, prefix_len=prefix_len)
        if fill is not None:
            cap = min(fill, window) if window else fill
            cache = {n: _seq_to_cache(leaf, cap)
                     for n, leaf in att.pack_kv(cfg, *kv).items()}
        elif return_kv:
            cache = kv
    h = h + mix
    if kind == "ssd":   # pre-norm only: no feed-forward after the mixer
        return h, cache, None
    h, aux = feed_forward(cfg, kind, p, h)
    return h, cache, aux


def forward(cfg, params, batch):
    """Teacher-forcing forward → (logits [B,S,V], aux_loss: the sum of
    the MoE layers' Switch losses, 0 without MoE layers).  Each layer
    group (one period of the block pattern) runs under ``cfg.remat``, as
    the reference's scanned groups do; the tail blocks do not."""
    h, positions = embed_inputs(cfg, params, batch)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)

    def group(h, aux, gp, kinds=group_kinds):
        for i, kind in enumerate(kinds):
            h, _, a = apply_block(cfg, kind, gp[f"b{i}"], h, positions)
            if a is not None:
                aux = aux + a
        return h, aux

    run = remat(cfg, group)
    for gp in unstack(params["layers"], n_groups):
        h, aux = run(h, aux, gp)
    for i, kind in enumerate(tail_kinds):
        h, aux = group(h, aux, {"b0": params[f"tail{i}"]}, [kind])
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h), aux


def _seq_to_cache(kv, capacity):
    """Place [B,S,...] K/V into a capacity-sized cache buffer (ring
    semantics when capacity < S: keep the last ``capacity`` positions at
    slots pos % capacity)."""
    S = kv.shape[1]
    if capacity == S:
        return kv
    if capacity > S:
        pad = kv.new_zeros((kv.shape[0], capacity - S) + kv.shape[2:])
        return torch.cat([kv, pad], dim=1)
    tail = kv[:, S - capacity:]
    return torch.roll(tail, shifts=(S - capacity) % capacity, dims=1)


def prefill(cfg, params, batch, capacity, *, prefix=None, prefix_len=None,
            last_index=None):
    """Run the prompt through the model → (last_logits [B,V], cache).

    Contiguous models (:func:`is_contiguous`): the grouped cache of
    :func:`init_cache` at ``capacity``, filled from the prompt (attention
    K/V packed and placed in ring slots, RG-LRU and SSD final states with
    their conv histories).

    Dense/MoE models: flat ``{"k", "v"}: [L, B, capacity, KVH, hd]``.  In
    prefix-aware mode ``prefix`` holds already-prefilled K/V ``[L, B,
    Tpad, KVH, hd]`` whose first ``prefix_len`` positions are valid; the
    batch then holds only the prompt suffix, whose positions start at
    ``prefix_len``, and the returned cache covers the suffix alone.
    ``last_index`` selects which position's logits to return (default:
    the last).  With :class:`ShardedParams` the sharded prefill
    (:func:`prefill_tp`)."""
    if isinstance(params, ShardedParams):
        return prefill_tp(cfg, params, batch, capacity, prefix=prefix,
                          prefix_len=prefix_len, last_index=last_index)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if capacity < S and any(k in ("attn_mlp", "attn_moe")
                            for k in block_kinds(cfg)):
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    h, positions = embed_inputs(cfg, params, batch)
    plen = int(prefix_len or 0)
    positions = positions + plen
    if is_contiguous(cfg):
        if prefix is not None:
            raise ValueError(f"{cfg.name}: prefix-aware prefill needs a "
                             f"positionally sliceable cache")
        caches = []
        for kind, p in blocks(cfg, params):
            h, c, _ = apply_block(cfg, kind, p, h, positions,
                                  fill=capacity)
            caches.append(c)
        cache = _group_caches(cfg, caches)
    else:
        ks, vs = [], []
        for i, (kind, p) in enumerate(blocks(cfg, params)):
            kw = {}
            if prefix is not None:
                kw = {"prefix_kv": (prefix["k"][i], prefix["v"][i]),
                      "prefix_len": plen}
            h, (k, v), _ = apply_block(cfg, kind, p, h, positions,
                                       return_kv=True, **kw)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
        if capacity > S:
            cache = {n: F.pad(t, (0, 0, 0, 0, 0, capacity - S))
                     for n, t in cache.items()}
    h = apply_norm(cfg, params["final_norm"], h)
    idx = S - 1 if last_index is None else int(last_index)
    logits = logits_from_hidden(cfg, params, h[:, idx:idx + 1])
    return logits[:, 0], cache


def _group_caches(cfg, caches):
    """Per-layer caches, in layer order → the grouped cache tree."""
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    P = len(group_kinds)
    out = {"layers": {
        f"b{i}": {n: torch.stack([caches[g * P + i][n]
                                  for g in range(n_groups)])
                  for n in caches[i]}
        for i in range(P)}}
    for i in range(len(tail_kinds)):
        out[f"tail{i}"] = caches[n_groups * P + i]
    return out


# ---------------------------------------------------------------------------
# contiguous cache and decode


def block_cache(cfg, kind, batch, capacity, dtype, device):
    if kind == "rglru_mlp":
        return rgmod.init_rglru_cache(cfg, batch, dtype, device)
    if kind == "ssd":
        return ssdmod.init_ssd_cache(cfg, batch, dtype, device)
    window = _window(cfg, kind)
    cap = min(capacity, window) if window else capacity
    return att.init_kv_cache(cfg, batch, cap, dtype, device)


def init_cache(cfg, batch, capacity, device):
    """Grouped contiguous cache mirroring the layer grouping: leaves
    ``[n_groups, batch, ...]`` under ``layers/b{i}``, ``[batch, ...]``
    under ``tail{i}``."""
    dtype = cfg.activation_dtype
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    cache = {"layers": {
        f"b{i}": {n: leaf[None].repeat((n_groups,) + (1,) * leaf.dim())
                  for n, leaf in block_cache(cfg, k, batch, capacity, dtype,
                                             device).items()}
        for i, k in enumerate(group_kinds)}}
    for i, k in enumerate(tail_kinds):
        cache[f"tail{i}"] = block_cache(cfg, k, batch, capacity, dtype,
                                        device)
    return cache


def decode_block(cfg, kind, p, h, cache, positions):
    """One block of one decode step; updates ``cache`` in place."""
    x = apply_norm(cfg, p["ln1"], h)
    if kind == "ssd":
        return h + ssdmod.decode_ssd(cfg, p["ssd"], x, cache)
    if kind == "rglru_mlp":
        h = h + rgmod.decode_rglru(cfg, p["rglru"], x, cache)
    else:
        h = h + att.decode_attention(cfg, p["attn"], x, cache, positions,
                                     window=_window(cfg, kind))
    return feed_forward(cfg, kind, p, h)[0]


def decode_step(cfg, params, cache, tokens, positions, capacity=None):
    """One decode step over the grouped contiguous cache: tokens [B,1],
    positions [B] (index of the current token).  Updates ``cache`` in
    place and returns (logits [B,V], cache).  With :class:`ShardedParams`
    the sharded step (:func:`decode_step_tp`), which reads the cache's
    ``capacity``."""
    if isinstance(params, ShardedParams):
        return decode_step_tp(cfg, params, cache, tokens, positions,
                              capacity)
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    for (kind, p), (_, c) in zip(blocks(cfg, params), blocks(cfg, cache)):
        h = decode_block(cfg, kind, p, h, c, positions)
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# paged decode (dense and MoE families, block-paged KV pools)


def init_paged_cache(cfg, num_pages, page_size, device):
    """Block-paged KV pool ``{"k", "v"}: [L, P, ps, KVH, hd]``."""
    if is_contiguous(cfg):
        raise ValueError(f"{cfg.name}: paged KV requires uniform global "
                         f"attention with unquantized KV")
    pool = att.init_paged_kv_cache(cfg, num_pages, page_size,
                                   cfg.activation_dtype, device)
    return {name: leaf[None].repeat(cfg.num_layers, 1, 1, 1, 1)
            for name, leaf in pool.items()}


def decode_step_paged(cfg, params, cache, tokens, positions, page_table):
    """One decode step over block-paged KV pools: tokens [B,1], positions
    [B], page_table [B,N] int32 (shared by every layer).  Writes the
    step's K/V into ``cache`` in place and returns (logits [B,V], cache).
    With :class:`ShardedParams` the sharded step
    (:func:`decode_step_paged_tp`)."""
    if isinstance(params, ShardedParams):
        return decode_step_paged_tp(cfg, params, cache, tokens, positions,
                                    page_table)
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    for i, (kind, p) in enumerate(blocks(cfg, params)):
        layer_kv = {"k": cache["k"][i], "v": cache["v"][i]}
        h = h + att.paged_decode_attention(
            cfg, p["attn"], apply_norm(cfg, p["ln1"], h), layer_kv,
            positions, page_table)
        h = feed_forward(cfg, kind, p, h)[0]
    h = apply_norm(cfg, params["final_norm"], h)
    return logits_from_hidden(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's "model" axis (ShardedParams)


def shard_key(rank: int) -> str:
    """The key of shard ``rank``'s cache tree in a sharded cache."""
    return f"shard{rank}"


def _on_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry)


class TensorParallel:
    """What the resolved parameter specs shard, for the sharded program.
    Each flag says whether a block's dim is split over ``model``; a dim
    the serving rules could not split is replicated (every shard holds
    the whole leaf, and a replicated block's output is whole on every
    shard: shard 0's is taken, nothing is summed):

    * ``attn_sum``: the q heads (``wo``'s contraction dims name
      ``model``: each shard's attention output is a partial sum);
    * ``kv_split``: the KV heads (else a contiguous cache is split by
      sequence where its slots divide the shard count, whole otherwise);
    * ``ffn_sum``: the MLP's hidden dim (the down projection is a partial
      sum); ``experts``: the MoE experts (the ``shard_map`` dispatch);
    * ``vocab``: the embedding's and the logits' vocab rows;
    * ``lru``: RG-LRU's width (replicated: every shard runs the whole
      block over the whole width and keeps the whole state);
    * ``ssd_heads``, ``ssd_fused``, ``ssd_conv``: the SSD block's heads
      (its ``ssm`` state), ``w_in``'s fused columns and the conv's
      columns (and its ``conv`` state), each split or whole on its own
      (:func:`~repro_torch.models.ssd.tp_layout`).

    Per shard, where the q heads are sharded over replicated KV heads,
    ``kv_heads[r]`` is the range of KV heads its q heads read and
    ``kv_runs[r]`` the runs in which they read them
    (:func:`~repro_torch.models.attention.kv_head_runs`: one run where the
    groups are equal); else both are None.  ``strategy`` is the
    parameters' (``heads`` for a serving engine's): the ulysses
    strategies hand the program attention weights gathered whole
    (:func:`~repro_torch.sharding.placement.gather_axes`); a serving
    program handed them split over their head_dim raises."""

    def __init__(self, cfg, params: ShardedParams):
        self._read(cfg, params.specs, params.tp)
        self.devices = params.devices
        self.strategy = getattr(params, "strategy", "heads")

    @classmethod
    def from_specs(cls, cfg, specs, tp):
        """The flags of parameter ``specs`` over ``tp`` shards, with no
        parameters placed (``devices`` None)."""
        self = object.__new__(cls)
        self._read(cfg, specs, tp)
        self.devices = None
        self.strategy = "heads"
        return self

    def _read(self, cfg, specs, tp):
        sp = _block_specs(cfg, specs)
        attn = next((s["attn"] for s in sp if "attn" in s), None)
        if attn is not None and any(
                _on_model(e) for e in (attn["wq"][2], attn["wo"][1])):
            raise NotImplementedError(
                "head_dim sharded over model (the ulysses strategies): "
                "serving runs the heads strategy")
        self.tp = tp
        self.attn_sum = attn is not None and _on_model(attn["wo"][0])
        self.kv_split = attn is not None and _on_model(attn["wk"][1])
        mlp = next((s["mlp"] for s in sp if "mlp" in s), None)
        self.ffn_sum = mlp is not None and _on_model(mlp["w_down"][0])
        moe = next((s["moe"] for s in sp if "moe" in s), None)
        self.experts = moe is not None and _on_model(moe["w_gate"][0])
        self.vocab = _on_model(specs["embed"][0])
        lru = next((s["rglru"] for s in sp if "rglru" in s), None)
        self.lru = lru is not None and _on_model(lru["w_in"][1])
        ssd = next((s["ssd"] for s in sp if "ssd" in s), None)
        self.ssd_heads = ssd is not None and cfg.ssm_heads % self.tp == 0
        self.ssd_fused = ssd is not None and _on_model(ssd["w_in"][1])
        self.ssd_conv = ssd is not None and _on_model(ssd["conv_w"][1])
        self.kv_heads, self.kv_runs = tp_kv_runs(cfg, self.tp, self.attn_sum,
                                                 self.kv_split)


def tp_kv_runs(cfg, tp, attn_sum, kv_split):
    """([each shard's KV head range], [each shard's runs]) where the q
    heads are sharded over replicated KV heads, else Nones."""
    if not attn_sum or kv_split:
        return [None] * tp, [None] * tp
    Hl = cfg.num_heads // tp
    runs = [att.kv_head_runs(cfg.num_heads, cfg.num_kv_heads, r * Hl, Hl)
            for r in range(tp)]
    return [(rs[0][2], rs[-1][3]) for rs in runs], runs


def uneven_groups(kv_runs) -> bool:
    """Some shard reads its KV heads in unequal groups (several runs)."""
    return any(r is not None and len(r) > 1 for r in kv_runs)


def _block_specs(cfg, specs):
    """The parameter specs of each distinct block (one per group slot,
    the layer dim dropped, then the tail blocks)."""
    group_kinds, _, tail_kinds = _layer_groups(cfg)

    def drop(t):
        return {k: drop(v) for k, v in t.items()} if isinstance(t, dict) \
            else tuple(t)[1:]
    return [drop(specs["layers"][f"b{i}"]) for i in range(len(group_kinds))] \
        + [specs[f"tail{i}"] for i in range(len(tail_kinds))]


def _tp_layers(cfg, params):
    """Per layer: (kind, [shard r's block parameters for r in ranks]).  A
    data coordinate's row (:class:`~repro_torch.sharding.placement.
    RowParams`) gathers each group of layers as the loop reaches it."""
    if not hasattr(params, "layer_tree"):
        per_rank = [blocks(cfg, s) for s in params.shards]
        return [(layer[0][0], [p for _, p in layer])
                for layer in zip(*per_rank)]
    return _row_layers(cfg, params)


def _row_layers(cfg, params):
    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    for g in range(n_groups):
        trees = params.layer_tree("layers", g)
        for i, kind in enumerate(group_kinds):
            yield kind, [t[f"b{i}"] for t in trees]
    for i, kind in enumerate(tail_kinds):
        yield kind, [s[f"tail{i}"] for s in params.shards]


def _tp_embed_inputs(cfg, params, tp, batch):
    """:func:`embed_inputs` over vocab-split embedding shards: each shard
    looks up the tokens in its rows (zeros elsewhere) and one reduce_sum
    adds the shards' rows (exact: one term is nonzero)."""
    tokens = batch["tokens"]
    h = tp_embed(cfg, [p["embed"] for p in params.shards], tp, tokens)
    B, S = tokens.shape
    if cfg.frontend == "patch_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None, :].repeat(B, 1)
    return h, positions


def tp_embed(cfg, tables, tp, tokens):
    """The embedding rows of ``tokens`` from the shards' ``tables`` (vocab
    rows under ``tp.vocab``, else whole: shard 0's)."""
    dt = cfg.activation_dtype
    if not tp.vocab:
        return tables[0].to(dt)[tokens.long()]
    parts = []
    for r, (E, t) in enumerate(zip(tables, broadcast(tokens, tp.devices))):
        Vl = E.shape[0]
        idx = t.long() - r * Vl
        keep = (idx >= 0) & (idx < Vl)
        parts.append(E.to(dt)[idx.clamp(0, Vl - 1)] * keep[..., None].to(dt))
    return reduce_sum(parts)[0]


def _tp_logits(cfg, params, tp, h):
    """Each shard's vocab slice of the logits, concatenated in rank order,
    then the padding masked (shard 0's whole table where vocab is not
    split)."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    return tp_logits(cfg, [p[name] for p in params.shards], tp, h,
                     transpose=cfg.tie_embeddings)


def tp_logits(cfg, tables, tp, h, *, transpose):
    parts = logit_parts(cfg, tables, tp, h, transpose=transpose)
    return mask_vocab_padding(cfg, gather(parts, -1) if tp.vocab
                              else parts[0])


def _tp_attention(cfg, tp, ps, h, attend, *, norm="ln1", key="attn"):
    """h + the attention of every shard (:func:`heads_attention`):
    ``attend(r, p, x)`` runs shard r's heads on its copy of the normed
    input."""
    x = apply_norm(cfg, ps[0][norm], h)
    return h + heads_attention(cfg, tp, ps, x,
                               lambda r, p, xr, _: attend(r, p, xr), key=key)


def _tp_feed_forward(cfg, tp, kind, ps, h, *, norm="ln2", gated=True,
                     with_aux=False):
    """h + the block's feed-forward over the shards (:func:`ffn_whole`).
    ``with_aux``: → (h, the MoE layer's aux loss or None)."""
    aux = []
    h = h + ffn_whole(cfg, tp, kind, ps, apply_norm(cfg, ps[0][norm], h),
                      aux, gated=gated)
    return (h, aux[0] if aux else None) if with_aux else h


def ffn_whole(cfg, tp, kind, ps, x, aux=None, *, gated=True):
    """The feed-forward of the whole normed ``x`` (on shard 0) in the
    heads layout → the output on shard 0: the MoE layer by the
    ``shard_map`` dispatch (the global one where the experts do not
    split; its aux loss appended to ``aux``), else the MLP, column- then
    row-parallel."""
    if kind == "attn_moe":
        if tp.experts:
            y, a = moemod.apply_moe_tp(cfg, [p["moe"] for p in ps], x,
                                       tp.devices)
        else:
            y, a = moemod.apply_moe_global(cfg, ps[0]["moe"], x)
        if aux is not None:
            aux.append(a)
        return y
    constrain_activation("act_ffn", x.shape[:-1] + (cfg.d_ff,),
                         [x.shape[:-1] + p["mlp"]["w_up"].shape[1:]
                          for p in ps])
    return mlpmod.apply_mlp_tp(cfg, [p["mlp"] for p in ps], x, tp.devices,
                               row_parallel=tp.ffn_sum, gated=gated)


def prefill_tp(cfg, params, batch, capacity, *, prefix=None,
               prefix_len=None, last_index=None, contiguous=False):
    """:func:`prefill` over sharded parameters → (last_logits [B,V] on
    shard 0's device, cache).  Attention-only families: the cache is
    ``{shard_key(r): {"k", "v"}}``, each shard's K/V ``[L, B, capacity,
    KVH_r, hd]`` on its device; ``prefix`` (prefix-aware mode) is such a
    tree too.  Contiguous models (or ``contiguous``, the dry-run's
    prefill, which fills the grouped cache as the reference's does):
    ``{shard_key(r): grouped cache}``, each shard's leaves at the serving
    rules' local shapes (:func:`init_cache_tp`), each block in the
    parameters' strategy's layout (:func:`_prefill_mesh`)."""
    if is_contiguous(cfg) or contiguous \
            or getattr(params, "strategy", "heads") != "heads":
        if prefix is not None:
            raise ValueError(f"{cfg.name}: prefix-aware prefill needs a "
                             f"positionally sliceable cache")
        return _prefill_mesh(cfg, params, batch, capacity)
    tp = TensorParallel(cfg, params)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    if capacity < S:
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    h, positions = _tp_embed_inputs(cfg, params, tp, batch)
    plen = int(prefix_len or 0)
    pos = broadcast(positions + plen, tp.devices)
    ks = [[] for _ in tp.devices]
    vs = [[] for _ in tp.devices]
    for i, (kind, ps) in enumerate(_tp_layers(cfg, params)):
        def attend(r, p, x, i=i):
            kw = {}
            if prefix is not None:
                pr = prefix[shard_key(r)]
                kw = {"prefix_kv": (pr["k"][i], pr["v"][i]),
                      "prefix_len": plen}
            out, (k, v) = att.full_attention(
                cfg, p["attn"], x, positions=pos[r], return_kv=True,
                kv_runs=tp.kv_runs[r], **kw)
            ks[r].append(k)
            vs[r].append(v)
            return out
        h = _tp_attention(cfg, tp, ps, h, attend)
        h = _tp_feed_forward(cfg, tp, kind, ps, h)
    cache = {}
    for r in range(len(tp.devices)):
        shard = {"k": torch.stack(ks[r]), "v": torch.stack(vs[r])}
        if capacity > S:
            shard = {n: F.pad(t, (0, 0, 0, 0, 0, capacity - S))
                     for n, t in shard.items()}
        cache[shard_key(r)] = shard
    h = apply_norm(cfg, params.shards[0]["final_norm"], h)
    idx = S - 1 if last_index is None else int(last_index)
    logits = _tp_logits(cfg, params, tp, h[:, idx:idx + 1])
    return logits[:, 0], cache


def decode_step_paged_tp(cfg, params, cache, tokens, positions, page_table):
    """:func:`decode_step_paged` over sharded parameters and a sharded pool
    (``{shard_key(r): {"k", "v"}}``, each shard's pool ``[L, P, ps,
    KVH_r, hd]`` on its device); every shard runs the paged decode kernel
    on its own heads.  → (logits [B,V] on shard 0's device, cache)."""
    tp = TensorParallel(cfg, params)
    h = _tp_embed_inputs(cfg, params, tp, {"tokens": tokens})[0]
    pos = broadcast(positions, tp.devices)
    tables = broadcast(page_table, tp.devices)
    pools = [cache[shard_key(r)] for r in range(len(tp.devices))]
    for i, (kind, ps) in enumerate(_tp_layers(cfg, params)):
        def attend(r, p, x, i=i):
            layer_kv = {"k": pools[r]["k"][i], "v": pools[r]["v"][i]}
            return att.paged_decode_attention(
                cfg, p["attn"], x, layer_kv, pos[r], tables[r],
                kv_runs=tp.kv_runs[r])
        h = _tp_attention(cfg, tp, ps, h, attend)
        h = _tp_feed_forward(cfg, tp, kind, ps, h)
    h = apply_norm(cfg, params.shards[0]["final_norm"], h)
    return _tp_logits(cfg, params, tp, h)[:, 0], cache


# -- the contiguous layout under a mesh --------------------------------------


def cache_layout_tp(cfg, params, batch, capacity):
    """(the grouped cache as ``meta`` tensors, its leaves' specs under the
    serving rules).  A leaf the rules do not split is whole on every
    shard: a K/V ring whose KV heads and slots both fail to split, a
    recurrent state whose width or heads do not divide the shard
    count."""
    meta = init_cache(cfg, batch, capacity, "meta")
    return meta, cache_pspecs(make_serving_rules(params.mesh, cfg), meta,
                              layout="contiguous")


def init_cache_tp(cfg, params, batch, capacity):
    """Each shard's zeroed contiguous cache: ``{shard_key(r): grouped
    cache}`` with the local shapes of the serving rules' ``cache_pspecs``,
    on the shard's device."""
    meta, specs = cache_layout_tp(cfg, params, batch, capacity)

    def zeros(tree, sp, coord):
        return {k: zeros(v, sp[k], coord) if isinstance(v, dict)
                else local_zeros(v.shape, v.dtype, sp[k], params.mesh, coord)
                for k, v in tree.items()}
    return {shard_key(r): zeros(meta, specs, c)
            for r, c in enumerate(params.ranks)}


def _localize(tree, meta, specs, mesh, coord):
    """Shard ``coord``'s part of a cache tree a shard computed: every dim
    it holds whole but the spec splits is cut to the shard's slice (e.g.
    a replicated KV head's slots); a dim already at its local size stays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _localize(v, meta[k], specs[k], mesh, coord)
            continue
        glob = meta[k].shape
        idx = []
        for d, sl in enumerate(shard_slices(glob, specs[k], mesh, coord)):
            n = sl.stop - sl.start
            if v.shape[d] == n:
                idx.append(slice(None))
            elif v.shape[d] == glob[d]:
                idx.append(sl)
            else:
                raise ValueError(f"cache leaf {k!r} {tuple(v.shape)}: dim "
                                 f"{d} is neither {glob[d]} nor {n}")
        out[k] = v[tuple(idx)].contiguous()
    return out


def _prefill_mesh(cfg, params, batch, capacity):
    """The contiguous prefill over sharded parameters (the dry-run's
    prefill step under any strategy): the blocks in the strategy's
    layout (:func:`mesh_block`), each shard's cache the K/V and states it
    computed cut to its slice of the serving rules' layout; the last
    position's logits."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if capacity < S and any(k in ("attn_mlp", "attn_moe")
                            for k in block_kinds(cfg)):
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    tp = TensorParallel(cfg, params)
    h, seq = mesh_embed(cfg, [p["embed"] for p in params.shards], tp,
                        batch)
    meta, specs = cache_layout_tp(cfg, params, B, capacity)
    per_shard = [[] for _ in params.devices]
    for kind, ps in _tp_layers(cfg, params):
        h, _, caches = mesh_block(cfg, kind, tp, ps, h, seq, fill=capacity)
        for r, c in enumerate(caches):
            per_shard[r].append(c)
    cache = {shard_key(r): _localize(_group_caches(cfg, cs), meta, specs,
                                     params.mesh, coord)
             for r, (cs, coord) in enumerate(zip(per_shard, params.ranks))}
    h = final_hidden(cfg, tp, seq, [p["final_norm"] for p in params.shards],
                     h, last=True)
    name = "embed" if cfg.tie_embeddings else "lm_head"
    logits = tp_logits(cfg, [p[name] for p in params.shards], tp, h,
                       transpose=cfg.tie_embeddings)
    return logits[:, 0], cache


def seq_split(tp, local, slots):
    """Whether a cache whose KV heads do not split, of ``slots`` slots in
    all and ``local`` a shard, is split by sequence (else every shard
    holds it whole)."""
    if local == slots:
        return False
    if local * tp.tp == slots:
        return True
    raise ValueError(f"a shard's cache of {local} slots is neither the "
                     f"{slots} slots nor their {tp.tp}-way split")


def tp_decode_attention(cfg, tp, ps, x, caches, positions, *, window=0,
                        key="attn", capacity=None):
    """One decode token's attention over a sharded contiguous cache (the
    block's normed input ``x`` on shard 0's device; ``caches[r]`` shard
    r's layer cache, written in place; ``capacity`` the positions the
    cache was made for, which a cache whose KV heads do not split needs)
    → the output on shard 0's device.

    KV heads split, or a cache whose slots do not split either (whole on
    every shard): each shard writes the step's K/V into its own cache and
    attends it with its own q heads (in runs over replicated KV heads,
    ``tp.kv_runs``; cut from whole weights by :func:`heads_view` where
    the cache's KV heads split but the weights came gathered).  Otherwise the cache is split by sequence (shard r
    holds slots ``[r·C_r, (r+1)·C_r)`` of ``C = tp·C_r``,
    :func:`seq_split`): each shard writes the step's K/V only where the
    row's slot is its own, q's heads are gathered to every shard, each
    shard's slots give a partial attention of all heads, one combine
    merges them (:func:`att.decode_attention_seq_split`) and each shard
    takes its own heads of the result into its rows of ``wo``."""
    xs = broadcast(x, tp.devices)
    pos = broadcast(positions, tp.devices)
    Cl = caches[0]["k"].shape[1]
    if not tp.kv_split and caches[0]["k"].shape[2] != cfg.num_kv_heads:
        # attention weights gathered whole (the ulysses strategies) over a
        # cache the rules split by KV heads: each shard runs the q heads
        # that read its KV heads
        ps, tp = heads_view(cfg, ps, key, tp)
    if not tp.kv_split:
        if capacity is None:
            raise ValueError(
                f"{cfg.name}: {cfg.num_kv_heads} KV heads do not split "
                f"{tp.tp} ways, so the cache may be whole or split by "
                f"sequence: pass the capacity")
    if tp.kv_split or not seq_split(
            tp, Cl, min(capacity, window) if window else capacity):
        outs = [att.decode_attention(cfg, p[key], xr, c, pr, window=window,
                                     kv_runs=runs)
                for p, xr, c, pr, runs in zip(ps, xs, caches, pos,
                                              tp.kv_runs)]
        return reduce_sum(outs)[0] if tp.attn_sum else outs[0]
    C = Cl * tp.tp
    qs = []
    for r, (p, xr, c, pr) in enumerate(zip(ps, xs, caches, pos)):
        q, k, v = att.decode_qkv(cfg, p[key], xr, pr)
        local = (pr % C if window > 0 else pr).long() - r * Cl
        att.write_decode_kv(cfg, c, k, v, local, own=(local >= 0)
                            & (local < Cl))
        qs.append(q)
    valid = att.decode_valid(positions, C, window)
    return seq_split_attention(
        cfg, tp, ps, qs, caches,
        [valid[:, r * Cl:(r + 1) * Cl].to(d).contiguous()
         for r, d in enumerate(tp.devices)], key=key)


def seq_split_attention(cfg, tp, ps, qs, caches, valids, *, key):
    """Attention of one decode token over a cache split by sequence:
    ``qs[r]`` shard r's q heads (only ``qs[0]`` is read where the heads
    are replicated), ``caches[r]`` and ``valids[r]`` its slots.  q's heads
    are gathered to every shard, each shard's slots give a partial
    attention of all heads, one combine merges them
    (:func:`att.decode_attention_seq_split`) and each shard takes its own
    heads of the result into its rows of ``wo`` → the output on shard 0's
    device."""
    q = gather(qs, 2).contiguous() if tp.attn_sum else qs[0].contiguous()
    out = att.decode_attention_seq_split(cfg, broadcast(q, tp.devices),
                                         caches, valids)
    if not tp.attn_sum:
        return att._out_proj(out, ps[0][key]["wo"])
    Hl = ps[0][key]["wo"].shape[0]
    return reduce_sum([
        att._out_proj(o[:, :, r * Hl:(r + 1) * Hl], p[key]["wo"])
        for r, (p, o) in enumerate(zip(ps, broadcast(out, tp.devices)))])[0]


def decode_step_tp(cfg, params, cache, tokens, positions, capacity):
    """:func:`decode_step` over sharded parameters and a sharded
    contiguous cache (``{shard_key(r): grouped cache}``, updated in place,
    of ``capacity`` positions: where the KV heads do not split it tells a
    whole ring from one split by sequence, :func:`seq_split`) → (logits
    [B,V] on shard 0's device, cache)."""
    tp = TensorParallel(cfg, params)
    h = _tp_embed_inputs(cfg, params, tp, {"tokens": tokens})[0]
    shard_blocks = [blocks(cfg, cache[shard_key(r)]) for r in range(tp.tp)]
    for i, (kind, ps) in enumerate(_tp_layers(cfg, params)):
        cs = [sb[i][1] for sb in shard_blocks]
        x = apply_norm(cfg, ps[0]["ln1"], h)
        if kind == "ssd":
            h = h + ssdmod.decode_ssd_tp(cfg, [p["ssd"] for p in ps], x, cs,
                                         tp.devices)
            continue
        if kind == "rglru_mlp":
            h = h + rgmod.decode_rglru_tp(cfg, [p["rglru"] for p in ps], x,
                                          cs, tp.devices)
        else:
            h = h + tp_decode_attention(cfg, tp, ps, x, cs, positions,
                                        window=_window(cfg, kind),
                                        capacity=capacity)
        h = _tp_feed_forward(cfg, tp, kind, ps, h)
    h = apply_norm(cfg, params.shards[0]["final_norm"], h)
    return _tp_logits(cfg, params, tp, h)[:, 0], cache


# ---------------------------------------------------------------------------
# training under a mesh: the data axes (FSDP, ZeRO-2) and the strategies


class MeshParams:
    """A train step's parameters on a mesh: ``tree`` (a
    :class:`~repro_torch.sharding.placement.ShardedTensor` a leaf, in the
    rules' layout), ``loc_trees[c]`` (coordinate c's differentiable local
    tree: the step's cast copies of the state's leaves) and ``strategy``
    (the rules' ``tp_strategy``).  A leaf is gathered for use over
    :func:`~repro_torch.sharding.placement.gather_axes` by one
    :func:`~repro_torch.sharding.placement.mesh_gather` over every
    coordinate (its backward the reduce-scatter); ``rows`` are the data
    coordinates' rows of ``model`` ranks."""

    def __init__(self, tree, loc_trees, strategy):
        self.tree = tree
        first = next(iter(flat_leaves(tree).values()))
        self.mesh = first.mesh
        self.coords = list(np.ndindex(self.mesh.devices.shape))
        self.rows = data_rows(self.mesh)
        self.loc_trees = loc_trees
        self.strategy = strategy
        self._layer_st = {}
        self.specs = {}
        for path, st in leaf_paths(tree):
            set_path(self.specs, path, drop_axes(st.spec, self.axes(path)))

    def axes(self, path: str) -> tuple:
        return gather_axes(self.mesh, path, self.strategy)

    def gathered(self, path: str) -> dict:
        """{coordinate: the top-level leaf ``path`` gathered for use}."""
        st = get_path(self.tree, path)
        return dict(zip(self.coords, mesh_gather(
            st, self.axes(path), self.coords,
            [get_path(self.loc_trees[c], path) for c in self.coords])))

    def layer_st(self, path: str, stacked: bool):
        """The layout of one layer of leaf ``path`` (a stacked leaf's
        layer dim dropped)."""
        st = get_path(self.tree, path)
        if not stacked:
            return st
        if path not in self._layer_st:
            self._layer_st[path] = ShardedTensor(
                NamedSharding(self.mesh, tuple(st.spec)[1:]),
                tuple(st.shape)[1:], st.dtype, None)
        return self._layer_st[path]

    def row_view(self, i: int):
        """(the row's coordinates, an object with the ``specs``,
        ``devices``, ``tp`` and ``strategy`` the tensor-parallel classes
        read)."""
        row = self.rows[i]
        return row, SimpleNamespace(
            specs=self.specs, tp=len(row), strategy=self.strategy,
            devices=[self.mesh.devices[c] for c in row])


def flat_leaves(tree) -> dict:
    """{path: leaf} of a tree of dicts."""
    return dict(leaf_paths(tree))


def mesh_layer(cfg, mp, prefix, layer_locs, fn, carry, *, stacked=True):
    """One layer of every coordinate under ``cfg.remat``: its leaves
    (``layer_locs[c]``, coordinate c's local slices of the subtree
    ``prefix``) gathered for use inside the rematerialised region (so a
    recompute gathers again, as FSDP does), then ``fn(per, carry)`` with
    ``per[c]`` coordinate c's gathered tree → the new carry."""
    paths = list(flat_leaves(layer_locs[mp.coords[0]]))
    n = len(mp.coords)

    def run(carry, *flat):
        per = {c: {} for c in mp.coords}
        for j, path in enumerate(paths):
            full = f"{prefix}/{path}"
            got = mesh_gather(mp.layer_st(full, stacked), mp.axes(full),
                              mp.coords, flat[j * n:(j + 1) * n])
            for c, t in zip(mp.coords, got):
                set_path(per[c], path, t)
        return fn(per, carry)

    flat = [get_path(layer_locs[c], path) for path in paths
            for c in mp.coords]
    return remat(cfg, run)(carry, *flat)


# -- the four strategies' layouts ---------------------------------------------

# strategy → (residual stream split by sequence, attention over each
# shard's sequence rows, MLP over each shard's rows); otherwise the
# residual is whole on shard 0, attention runs each shard's heads and the
# MLP its columns.  The recurrent mixers and the MoE layer run the heads
# layout on the whole sequence under every strategy: a recurrence (and
# its conv) runs along the whole sequence, and MoE's capacity counts the
# row's whole token set, as the reference's dispatch does
LAYOUTS = {"heads": (False, False, False),
           "ulysses": (False, True, False),
           "heads_sp": (True, False, False),
           "ulysses_sp": (True, True, True)}


class SeqSplit:
    """A row's sequence of ``S`` positions over its shards' ``devices``:
    shard r holds rows ``[r·S/tp, (r+1)·S/tp)`` where S splits tp ways,
    else every shard holds the whole sequence (the activation rules'
    fallback for a dim the model axis does not divide).  ``whole[r]`` and
    ``rows[r]`` are the positions [B, S] and [B, S_r] on shard r."""

    def __init__(self, B, S, devices):
        self.devices = list(devices)
        n = len(self.devices)
        self.S, self.split = S, S % n == 0
        self.Sl = S // n if self.split else S
        pos = torch.arange(S, dtype=torch.int32,
                           device=self.devices[0])[None].repeat(B, 1)
        self.whole = broadcast(pos, self.devices)
        self.rows = [w[:, self.offset(r):self.offset(r) + self.Sl]
                     for r, w in enumerate(self.whole)]

    def offset(self, r) -> int:
        return r * self.Sl if self.split else 0

    def scatter(self, h) -> list:
        """A whole [B, S, ...] tensor (on shard 0) → each shard's rows."""
        hs = broadcast(h, self.devices)
        if not self.split:
            return hs
        return [hr[:, self.offset(r):self.offset(r) + self.Sl].contiguous()
                for r, hr in enumerate(hs)]

    def gather(self, parts):
        """Each shard's rows → the whole tensor on shard 0's device."""
        return gather(parts, 1) if self.split else parts[0]

    def all_gather(self, parts) -> list:
        """Each shard's rows → the whole tensor on every shard (K and V
        all-gathered over the sequence)."""
        return all_gather(parts, 1) if self.split else list(parts)


def residual(cfg, tp, seq, ps, h, norm, *, whole=None, rows=None):
    """h + f(norm(h)) in the row's residual layout (``tp.strategy``):
    ``whole(x)`` takes the normed input whole on shard 0 and gives its
    output there, ``rows(xs)`` each shard's normed rows and gives each
    shard's output rows.  Where the residual is split by sequence a whole
    f gathers the rows and scatters its output; where it is whole a rows
    f scatters the input and gathers the output."""
    if not LAYOUTS[tp.strategy][0]:
        x = apply_norm(cfg, ps[0][norm], h)
        return h + (whole(x) if rows is None
                    else seq.gather(rows(seq.scatter(x))))
    constrain_activation("act_hidden", (h[0].shape[0], seq.S,
                                        h[0].shape[-1]),
                         [hr.shape for hr in h])
    xs = [apply_norm(cfg, p[norm], hr) for p, hr in zip(ps, h)]
    ys = rows(xs) if rows is not None else seq.scatter(whole(seq.gather(xs)))
    return [hr + y for hr, y in zip(h, ys)]


def rows_attention(cfg, ps, xs, seq, *, key="attn", causal=True, window=0,
                   memory=None, caches=None, cap=None):
    """Each shard's attention of its normed query rows ``xs[r]`` with the
    layer's whole weights → each shard's output rows.  Self-attention:
    the shards' K/V all-gathered over the sequence; shard r's queries,
    rows ``[off_r, off_r + S_r)``, attend them causally in flash's prefix
    form (``prefix_pad = prefix_len = off_r``, a window reaching back
    across the shard boundary), or every key where not ``causal`` (the
    encoder).  ``memory``: cross-attention, each shard's whole (K, V).
    With ``cap`` each shard's ``caches[r]`` is its whole K/V packed into
    ``cap`` slots."""
    B = xs[0].shape[0]
    qs, ks, vs = [], [], []
    for p, x, pr in zip(ps, xs, seq.rows):
        q = att._project_q(cfg, p[key], x)
        if memory is None:
            k, v = att._project_kv(cfg, p[key], x)
            if cfg.use_rope:
                cos, sin = rope_cos_sin(pr, cfg.head_dim, cfg.rope_theta,
                                        x.dtype)
                q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
            ks.append(k)
            vs.append(v)
        qs.append(q)
    constrain_activation("act_qkv", (B, seq.S, cfg.num_heads, cfg.head_dim),
                         [q.shape for q in qs])
    if memory is None:
        K, V = seq.all_gather(ks), seq.all_gather(vs)
        constrain_activation("act_kv", (B, seq.S, cfg.num_kv_heads,
                                        cfg.head_dim), [k.shape for k in K])
    else:
        K, V = [k for k, _ in memory], [v for _, v in memory]
    outs = []
    for r, (p, q, k, v) in enumerate(zip(ps, qs, K, V)):
        off = seq.offset(r) if memory is None and causal else 0
        o = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, prefix_pad=off,
                                   prefix_len=off)
        outs.append(att._out_proj(o, p[key]["wo"]))
        if cap is not None:
            caches[r] = {n: _seq_to_cache(leaf, cap)
                         for n, leaf in att.pack_kv(cfg, k, v).items()}
    return outs


def rows_mlp(cfg, ps, xs, seq, *, gated=True):
    """Each shard's MLP of its normed rows, with the layer's whole
    weights."""
    constrain_activation("act_ffn", (xs[0].shape[0], seq.S, cfg.d_ff),
                         [x.shape[:-1] + (cfg.d_ff,) for x in xs])
    return [mlpmod.apply_mlp(cfg, p["mlp"], x, gated=gated)
            for p, x in zip(ps, xs)]


def heads_view(cfg, ps, key, tp):
    """Each shard's attention parameters ``p[key]`` cut from whole
    (gathered) weights to the layout the heads rules give: its q heads
    and their rows of ``wo`` where the heads split the shard count, its
    KV heads where theirs do (else every KV head, read in runs) → (each
    shard's parameter tree, flags as :class:`TensorParallel` gives them:
    ``attn_sum``, ``kv_split``, ``kv_heads``, ``kv_runs``)."""
    n = tp.tp
    H, KVH = cfg.num_heads, cfg.num_kv_heads
    attn_sum, kv_split = H % n == 0, KVH % n == 0
    Hl = H // n if attn_sum else H
    Kl = KVH // n if kv_split else KVH
    out = []
    for r, p in enumerate(ps):
        q0, k0 = (r * Hl if attn_sum else 0), (r * Kl if kv_split else 0)
        cut = {}
        for name, w in p[key].items():
            if name in ("wq", "wk", "wv"):
                w = w.narrow(1, *((q0, Hl) if name == "wq" else (k0, Kl)))
            elif name in ("wo", "bq", "bk", "bv"):
                w = w.narrow(0, *((k0, Kl) if name in ("bk", "bv")
                                  else (q0, Hl)))
            cut[name] = w
        out.append({**p, key: cut})
    kv_heads, kv_runs = tp_kv_runs(cfg, n, attn_sum, kv_split)
    return out, SimpleNamespace(
        tp=n, attn_sum=attn_sum, kv_split=kv_split, kv_heads=kv_heads,
        kv_runs=kv_runs, devices=tp.devices, strategy="heads")


def heads_attention(cfg, tp, ps, x, attend, *, key="attn", every=True):
    """Every shard's q heads over the whole normed ``x`` (on shard 0):
    ``attend(r, p, x_r, kv_runs)`` runs shard r's heads with ``p`` its
    parameters (cut by :func:`heads_view` under ``heads_sp``, whose
    attention weights come gathered) → the output on shard 0: the partial
    sums reduced where the heads split, else shard 0's, which alone is
    computed unless ``every`` (a prefill fills every shard's cache)."""
    if tp.strategy == "heads_sp":
        ps, tp = heads_view(cfg, ps, key, tp)
    xs = broadcast(x, tp.devices)
    if not (tp.attn_sum or every):
        xs = xs[:1]
    constrain_activation("act_qkv", x.shape[:-1] + (cfg.num_heads,
                                                    cfg.head_dim),
                         [x.shape[:-1] + p[key]["wq"].shape[1:]
                          for p in ps[:len(xs)]])
    outs = [attend(r, p, xr, tp.kv_runs[r])
            for r, (p, xr) in enumerate(zip(ps, xs))]
    return reduce_sum(outs)[0] if tp.attn_sum else outs[0]


def mesh_block(cfg, kind, tp, ps, h, seq, *, fill=None):
    """One block of one row in the layout of ``tp.strategy``
    (:data:`LAYOUTS`; ``h`` whole on shard 0 or each shard's rows of
    ``seq``) → (h, the MoE layer's aux loss or None, each shard's block
    cache where ``fill`` gives a capacity, else Nones)."""
    caches = [None] * tp.tp
    _, by_rows, mlp_rows = LAYOUTS[tp.strategy]
    if kind in _RECURRENT:
        name = _RECURRENT[kind][0]
        fn = rgmod.apply_rglru_tp if kind == "rglru_mlp" \
            else ssdmod.apply_ssd_tp

        def mix(x):
            out = fn(cfg, [p[name] for p in ps], x, tp.devices,
                     return_state=fill is not None)
            if fill is None:
                return out
            caches[:] = out[1]
            return out[0]
        h = residual(cfg, tp, seq, ps, h, "ln1", whole=mix)
    else:
        window = _window(cfg, kind)
        cap = None if fill is None else min(fill, window) if window \
            else fill
        if by_rows:
            h = residual(cfg, tp, seq, ps, h, "ln1", rows=lambda xs:
                         rows_attention(cfg, ps, xs, seq, window=window,
                                        caches=caches, cap=cap))
        else:
            def attend(r, p, x, runs):
                out, kv = att.full_attention(
                    cfg, p["attn"], x, positions=seq.whole[r], window=window,
                    return_kv=True, kv_runs=runs)
                if cap is not None:
                    caches[r] = {n: _seq_to_cache(leaf, cap) for n, leaf
                                 in att.pack_kv(cfg, *kv).items()}
                return out
            h = residual(cfg, tp, seq, ps, h, "ln1", whole=lambda x:
                         heads_attention(cfg, tp, ps, x, attend,
                                         every=fill is not None))
    if kind == "ssd":   # pre-norm only: no feed-forward after the mixer
        return h, None, caches
    aux = []
    if mlp_rows and kind != "attn_moe":
        h = residual(cfg, tp, seq, ps, h, "ln2",
                     rows=lambda xs: rows_mlp(cfg, ps, xs, seq))
    else:
        h = residual(cfg, tp, seq, ps, h, "ln2",
                     whole=lambda x: ffn_whole(cfg, tp, kind, ps, x, aux))
    return h, (aux[0] if aux else None), caches


def mesh_embed(cfg, tables, tp, batch):
    """A row's embedded tokens in its residual layout (whole on shard 0,
    or each shard's rows) and its :class:`SeqSplit`."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = tp_embed(cfg, tables, tp, tokens)
    if cfg.frontend == "patch_stub" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(h.dtype)
        h = torch.cat([pe, h[:, pe.shape[1]:]], dim=1)
    seq = SeqSplit(B, S, tp.devices)
    return (seq.scatter(h) if LAYOUTS[tp.strategy][0] else h), seq


def final_hidden(cfg, tp, seq, norms, h, *, last=False):
    """The final norm of the residual stream, whole on a shard (``last``:
    its last position only, on the shard that holds it)."""
    if not LAYOUTS[tp.strategy][0]:
        return apply_norm(cfg, norms[0], h[:, -1:] if last else h)
    if last:
        r = len(h) - 1 if seq.split else 0
        return apply_norm(cfg, norms[r], h[r][:, -1:])
    return seq.gather([apply_norm(cfg, n, hr) for n, hr in zip(norms, h)])


def logit_parts(cfg, tables, tp, h, *, transpose):
    """Each shard's vocab slice of the logits of a replicated h (shard
    0's whole table where vocab is not split), padding not yet masked."""
    hs = broadcast(h, tp.devices) if tp.vocab else [h]
    parts = [hr @ (w.to(hr.dtype).T if transpose else w.to(hr.dtype))
             for w, hr in zip(tables, hs)]
    constrain_activation("act_logits", h.shape[:-1] + (cfg.vocab_padded,),
                         [p.shape for p in parts])
    return parts


def forward_tp(cfg, mp, batch_rows):
    """The teacher-forcing forward of every data coordinate's row →
    per row (each shard's vocab slice of the logits, the row's MoE aux
    loss).  Layers run in order, every row's block of a layer under one
    :func:`mesh_layer` (its leaves gathered inside remat), each in its
    strategy's layout (:func:`mesh_block`)."""
    top = {p: mp.gathered(p) for p in flat_leaves(mp.tree)
           if p.split("/")[0] not in ("layers",)
           and not p.startswith("tail")}
    name = "embed" if cfg.tie_embeddings else "lm_head"
    rows, hs, aux = [], [], []
    for i, batch in enumerate(batch_rows):
        row, view = mp.row_view(i)
        tp = TensorParallel(cfg, view)
        with on_row(row):
            h, seq = mesh_embed(cfg, [top["embed"][c] for c in row], tp,
                                batch)
        rows.append((row, tp, seq))
        hs.append(h)
        aux.append(torch.zeros((), dtype=torch.float32,
                               device=view.devices[0]))

    def block(kind):
        def fn(per, carry):
            hs, aux = carry
            out_h, out_a = [], []
            for (row, tp, seq), h, a in zip(rows, hs, aux):
                with on_row(row):
                    h, b, _ = mesh_block(cfg, kind, tp, [per[c] for c in row],
                                         h, seq)
                out_h.append(h)
                out_a.append(a + b if b is not None else a)
            return out_h, out_a
        return fn

    group_kinds, n_groups, tail_kinds = _layer_groups(cfg)
    unst = {c: unstack(mp.loc_trees[c]["layers"], n_groups)
            for c in mp.coords}
    carry = (hs, aux)
    for g in range(n_groups):
        for i, kind in enumerate(group_kinds):
            carry = mesh_layer(cfg, mp, f"layers/b{i}",
                               {c: unst[c][g][f"b{i}"] for c in mp.coords},
                               block(kind), carry)
    for i, kind in enumerate(tail_kinds):
        carry = mesh_layer(cfg, mp, f"tail{i}",
                           {c: mp.loc_trees[c][f"tail{i}"]
                            for c in mp.coords}, block(kind), carry,
                           stacked=False)
    out = []
    for (row, tp, seq), h, a in zip(rows, *carry):
        with on_row(row):
            h = final_hidden(cfg, tp, seq, [top_tree(top, "final_norm", c)
                                            for c in row], h)
            parts = logit_parts(cfg, [top[name][c] for c in row], tp, h,
                                transpose=cfg.tie_embeddings)
        out.append((parts, a, tp.vocab))
    return out


def top_tree(top, prefix, c) -> dict:
    """Coordinate c's gathered subtree ``prefix`` of the top leaves."""
    out = {}
    for path, by_coord in top.items():
        if path.split("/")[0] == prefix:
            set_path(out, path.split("/", 1)[1], by_coord[c])
    return out


def vocab_loss(cfg, parts, targets, vocab_split):
    """The reference's next-token loss over vocab-sharded logits ``parts``
    (float32 after the padding is masked): logsumexp is a
    :func:`reduce_max` (a constant shift) and a :func:`reduce_sum` of the
    shards' exponential sums, the target's logit comes from its owning
    shard (one :func:`reduce_sum`; the others add 0) → (nll, zloss)."""
    Vl = parts[0].shape[-1]
    devices = [p.device for p in parts]
    ts = broadcast(targets.long(), devices) if vocab_split else [targets]
    fl = []
    for r, p in enumerate(parts):
        col = torch.arange(r * Vl, (r + 1) * Vl, device=p.device)
        fl.append(torch.where(col < cfg.vocab_size, p, torch.full(
            (), -1e30, dtype=p.dtype, device=p.device)).float())
    if not vocab_split:
        logz = torch.logsumexp(fl[0], dim=-1)
        gold = fl[0].gather(-1, ts[0].long()[..., None])[..., 0]
    else:
        m = reduce_max([p.amax(-1) for p in fl])
        s = reduce_sum([torch.exp(p - mr[..., None]).sum(-1)
                        for p, mr in zip(fl, m)])
        logz = m[0] + torch.log(s[0])
        golds = []
        for r, (p, t) in enumerate(zip(fl, ts)):
            idx = t - r * Vl
            own = (idx >= 0) & (idx < Vl)
            g = p.gather(-1, idx.clamp(0, Vl - 1)[..., None])[..., 0]
            golds.append(torch.where(own, g, torch.zeros((), device=p.device)))
        gold = reduce_sum(golds)[0]
    nll = (logz - gold).mean()
    return nll, 1e-4 * logz.square().mean()
