"""Encoder-decoder transformer (the Whisper backbone).

Counterpart of ``repro/models/encdec.py``.  The conv audio front end is a
stub, as in the reference: callers pass frame embeddings ``[B, enc_seq,
D]`` as ``batch["encoder_frames"]``.  Positions are sinusoidal, computed
on the fly.  Parameters keep the reference's stacked tree (``enc_layers``
and ``dec_layers``, each leaf ``[L, ...]``); layers run in a Python loop.

Every attention product runs in a kernel: the encoder's non-causal
self-attention, the decoder's causal self-attention and the prefill's
cross-attention (S query rows over ``enc_seq`` keys) in flash; a decode
step's self-attention over its contiguous cache and its cross-attention
over the encoder memory in the contiguous decode kernel (the reference
computes the cross-attention and the encoder with plain attention).

Under tensor parallelism (:class:`~repro_torch.sharding.placement.
ShardedParams`; :func:`prefill_tp`, :func:`decode_step_tp`) the model
runs at the model level, as the reference runs it (its engine cannot
admit an encoder-decoder request): the encoder's and decoder's
attentions at each shard's heads, the self cache and the cross memory
split by KV heads, the MLPs column- then row-parallel and the logits
split by vocab, with the pieces of :mod:`.lm`'s sharded program.  What
does not divide the shard count is replicated, as the serving rules
place it: KV heads that do not split leave each cache split by sequence
where its slots divide (the cross memory's 1500 frames over three
shards: each shard's partial attention over its frames, one combine),
else whole on every shard (the self cache's 448 slots).
"""

from __future__ import annotations

import torch

from . import attention as att
from . import mlp as mlpmod
from .common import (PSpec, apply_norm, norm_schema, remat,
                     sinusoidal_positions, stack_schema)
from repro_torch.sharding.placement import (
    ShardedParams,
    broadcast,
    on_row,
    reduce_sum,
)
from repro_torch.sharding.rules import cache_pspecs, make_serving_rules

from .lm import (
    LAYOUTS,
    SeqSplit,
    _localize,
    _on_model,
    _seq_to_cache,
    _tp_attention,
    _tp_feed_forward,
    ffn_whole,
    final_hidden,
    flat_leaves,
    heads_attention,
    heads_view,
    logit_parts,
    mask_vocab_padding,
    mesh_layer,
    residual,
    rows_attention,
    rows_mlp,
    seq_split,
    seq_split_attention,
    shard_key,
    top_tree,
    tp_decode_attention,
    tp_embed,
    tp_kv_runs,
    tp_logits,
    unstack,
)


def enc_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": att.attn_schema(cfg),
            "ln2": norm_schema(cfg),
            "mlp": mlpmod.mlp_schema(cfg, gated=False)}


def dec_block_schema(cfg):
    return {"ln1": norm_schema(cfg), "self_attn": att.attn_schema(cfg),
            "ln2": norm_schema(cfg),
            "cross_attn": att.attn_schema(cfg, cross=True),
            "ln3": norm_schema(cfg),
            "mlp": mlpmod.mlp_schema(cfg, gated=False)}


def encdec_schema(cfg) -> dict:
    V, D = cfg.vocab_padded, cfg.d_model
    return {
        "embed": PSpec((V, D), "embed", axes=("vocab", "embed")),
        "enc_final_norm": norm_schema(cfg),
        "dec_final_norm": norm_schema(cfg),
        "enc_layers": stack_schema(enc_block_schema(cfg), cfg.enc_layers),
        "dec_layers": stack_schema(dec_block_schema(cfg), cfg.num_layers),
    }


def _logits(cfg, params, h):
    """The tied head: h @ embed^T, vocab padding masked."""
    return mask_vocab_padding(cfg, h @ params["embed"].to(h.dtype).T)


def encode(cfg, params, frames):
    """frames: [B, T_enc, D] (the stubbed conv front end's output) →
    encoder output [B, T_enc, D] in the frames' dtype."""
    B, T, D = frames.shape
    pos = torch.arange(T, dtype=torch.int32, device=frames.device)
    h = frames + sinusoidal_positions(pos, D, frames.dtype)[None]
    positions = pos[None, :].repeat(B, 1)

    def layer(h, p):
        h = h + att.full_attention(cfg, p["attn"],
                                   apply_norm(cfg, p["ln1"], h),
                                   positions=positions, causal=False)
        return h + mlpmod.apply_mlp(cfg, p["mlp"],
                                    apply_norm(cfg, p["ln2"], h),
                                    gated=False)

    run = remat(cfg, layer)
    for p in unstack(params["enc_layers"], cfg.enc_layers):
        h = run(h, p)
    return apply_norm(cfg, params["enc_final_norm"], h)


def dec_forward(cfg, params, tokens, enc_out, *, fill_cache=False,
                capacity=0):
    """Decoder teacher-forcing pass → (logits [B,S,V], cache or None).
    With ``fill_cache`` the cache is ``{k, v: [L, B, capacity, KVH, hd],
    cross_k, cross_v: [L, B, enc_seq, KVH, hd]}``."""
    B, S = tokens.shape
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    h = h + sinusoidal_positions(pos, cfg.d_model, h.dtype)[None]
    positions = pos[None, :].repeat(B, 1)

    def layer(h, p):
        a, (k, v) = att.full_attention(
            cfg, p["self_attn"], apply_norm(cfg, p["ln1"], h),
            positions=positions, causal=True, return_kv=True)
        h = h + a
        # the encoder memory's K/V, projected once: attended here and,
        # with fill_cache, kept as the decode steps' cross cache
        cross = att.cross_attention_cache(cfg, p["cross_attn"], enc_out)
        h = h + att.full_attention(cfg, p["cross_attn"],
                                   apply_norm(cfg, p["ln2"], h),
                                   positions=positions,
                                   kv=(cross["k"], cross["v"]), causal=False)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], h),
                                 gated=False)
        return h, k, v, cross

    run = remat(cfg, layer)
    caches = []
    for p in unstack(params["dec_layers"], cfg.num_layers):
        h, k, v, cross = run(h, p)
        if fill_cache:
            caches.append({"k": _seq_to_cache(k, capacity),
                           "v": _seq_to_cache(v, capacity),
                           "cross_k": cross["k"], "cross_v": cross["v"]})
    h = apply_norm(cfg, params["dec_final_norm"], h)
    cache = {n: torch.stack([c[n] for c in caches]) for n in caches[0]} \
        if fill_cache else None
    return _logits(cfg, params, h), cache


def forward(cfg, params, batch):
    """→ (logits [B,S,V], aux 0)."""
    enc_out = encode(cfg, params, batch["encoder_frames"])
    logits, _ = dec_forward(cfg, params, batch["tokens"], enc_out)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def init_cache(cfg, batch, capacity, device):
    """Zeroed decode cache ``{"dec": {k, v: [L, batch, capacity, KVH, hd],
    cross_k, cross_v: [L, batch, enc_seq, KVH, hd]}}``."""
    L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shapes = {"k": (L, batch, capacity, KVH, hd),
              "v": (L, batch, capacity, KVH, hd),
              "cross_k": (L, batch, cfg.enc_seq, KVH, hd),
              "cross_v": (L, batch, cfg.enc_seq, KVH, hd)}
    return {"dec": {n: torch.zeros(s, dtype=cfg.activation_dtype,
                                   device=device)
                    for n, s in shapes.items()}}


def prefill(cfg, params, batch, capacity):
    """Encode the frames and run the decoder prompt → (last logits [B,V],
    cache).  With :class:`ShardedParams` the sharded prefill
    (:func:`prefill_tp`)."""
    if isinstance(params, ShardedParams):
        return prefill_tp(cfg, params, batch, capacity)
    if capacity < batch["tokens"].shape[1]:
        raise ValueError(f"capacity {capacity} < prompt length "
                         f"{batch['tokens'].shape[1]}")
    enc_out = encode(cfg, params, batch["encoder_frames"])
    logits, cache = dec_forward(cfg, params, batch["tokens"], enc_out,
                                fill_cache=True, capacity=capacity)
    return logits[:, -1], {"dec": cache}


def decode_step(cfg, params, cache, tokens, positions, capacity=None):
    """tokens [B,1]; positions [B] (index of the current token) →
    (logits [B,V], cache).  The step's self-attention K/V are written into
    ``cache`` in place; the cross-attention memory is read only.  With
    :class:`ShardedParams` the sharded step (:func:`decode_step_tp`), which
    reads the self cache's ``capacity``."""
    if isinstance(params, ShardedParams):
        return decode_step_tp(cfg, params, cache, tokens, positions,
                              capacity)
    B = tokens.shape[0]
    h = params["embed"].to(cfg.activation_dtype)[tokens.long()]
    h = h + sinusoidal_positions(positions[:, None], cfg.d_model, h.dtype)
    dc = cache["dec"]
    valid = torch.ones(B, cfg.enc_seq, dtype=torch.bool, device=h.device)
    for i, p in enumerate(unstack(params["dec_layers"], cfg.num_layers)):
        h = h + att.decode_attention(
            cfg, p["self_attn"], apply_norm(cfg, p["ln1"], h),
            {"k": dc["k"][i], "v": dc["v"][i]}, positions)
        h = h + att.cross_decode_attention(
            cfg, p["cross_attn"], apply_norm(cfg, p["ln2"], h),
            dc["cross_k"][i], dc["cross_v"][i], valid)
        h = h + mlpmod.apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln3"], h),
                                 gated=False)
    h = apply_norm(cfg, params["dec_final_norm"], h)
    return _logits(cfg, params, h)[:, 0], cache


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's "model" axis (ShardedParams)


class EncDecTP:
    """What the resolved specs shard (the fields :mod:`.lm`'s sharded
    pieces read): ``attn_sum`` (heads split: each attention's output is a
    partial sum), ``kv_split``, ``ffn_sum`` (the MLPs' hidden dim),
    ``vocab``, and each shard's ``kv_heads`` and ``kv_runs``
    (:func:`~repro_torch.models.lm.tp_kv_runs`), and the parameters'
    ``strategy``.  A dim that is not split is replicated: its block's
    output is shard 0's."""

    experts = False

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
        dec = specs["dec_layers"]
        attn = dec["self_attn"]     # leaves [L, ...]
        if _on_model(attn["wq"][3]) or _on_model(attn["wo"][2]):
            raise NotImplementedError(
                "head_dim sharded over model (the ulysses strategies): "
                "serving runs the heads strategy")
        self.tp = tp
        self.attn_sum = _on_model(attn["wo"][1])
        self.kv_split = _on_model(attn["wk"][2])
        self.ffn_sum = _on_model(dec["mlp"]["w_down"][1])
        self.vocab = _on_model(specs["embed"][0])
        self.kv_heads, self.kv_runs = tp_kv_runs(cfg, self.tp, self.attn_sum,
                                                 self.kv_split)


def _tp_stack(params, name, n):
    """Per layer: [shard r's layer parameters for r in ranks]; a data
    coordinate's row gathers each layer as the loop reaches it."""
    if hasattr(params, "layer_tree"):
        return (params.layer_tree(name, i) for i in range(n))
    return list(zip(*[unstack(s[name], n) for s in params.shards]))


def encode_tp(cfg, params, tp, frames):
    """:func:`encode` over the shards → the encoder output on shard 0's
    device."""
    B, T, D = frames.shape
    pos = torch.arange(T, dtype=torch.int32, device=frames.device)
    h = frames + sinusoidal_positions(pos, D, frames.dtype)[None]
    positions = broadcast(pos[None, :].repeat(B, 1), tp.devices)
    for ps in _tp_stack(params, "enc_layers", cfg.enc_layers):
        h = _tp_attention(cfg, tp, ps, h, lambda r, p, x: att.full_attention(
            cfg, p["attn"], x, positions=positions[r], causal=False,
            kv_runs=tp.kv_runs[r]))
        h = _tp_feed_forward(cfg, tp, "mlp", ps, h, gated=False)
    return apply_norm(cfg, params.shards[0]["enc_final_norm"], h)


def _tp_dec_embed(cfg, params, tp, tokens, positions):
    h = tp_embed(cfg, [p["embed"] for p in params.shards], tp, tokens)
    return h + sinusoidal_positions(positions, cfg.d_model, h.dtype)


def prefill_tp(cfg, params, batch, capacity):
    """:func:`prefill` over sharded parameters → (last logits [B,V] on
    shard 0's device, ``{shard_key(r): {"dec": {k, v, cross_k,
    cross_v}}}``: each shard's caches at the local shapes of the serving
    rules' ``cache_pspecs``, on its device)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if capacity < S:
        raise ValueError(f"capacity {capacity} < prompt length {S}")
    tp = EncDecTP(cfg, params)
    enc = broadcast(encode_tp(cfg, params, tp, batch["encoder_frames"]),
                    tp.devices)
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
    h = _tp_dec_embed(cfg, params, tp, tokens, pos[None])
    positions = broadcast(pos[None, :].repeat(B, 1), tp.devices)
    caches = [[] for _ in tp.devices]
    for ps in _tp_stack(params, "dec_layers", cfg.num_layers):
        def self_attend(r, p, x):
            out, (k, v) = att.full_attention(
                cfg, p["self_attn"], x, positions=positions[r], causal=True,
                return_kv=True, kv_runs=tp.kv_runs[r])
            caches[r].append({"k": _seq_to_cache(k, capacity),
                              "v": _seq_to_cache(v, capacity)})
            return out

        def cross_attend(r, p, x):
            cross = att.cross_attention_cache(cfg, p["cross_attn"], enc[r])
            caches[r][-1].update(cross_k=cross["k"], cross_v=cross["v"])
            return att.full_attention(cfg, p["cross_attn"], x,
                                      positions=positions[r],
                                      kv=(cross["k"], cross["v"]),
                                      causal=False, kv_runs=tp.kv_runs[r])
        h = _tp_attention(cfg, tp, ps, h, self_attend, key="self_attn")
        h = _tp_attention(cfg, tp, ps, h, cross_attend, norm="ln2",
                          key="cross_attn")
        h = _tp_feed_forward(cfg, tp, "mlp", ps, h, norm="ln3", gated=False)
    h = apply_norm(cfg, params.shards[0]["dec_final_norm"], h[:, -1:])
    logits = tp_logits(cfg, [p["embed"] for p in params.shards], tp, h,
                       transpose=True)
    meta = init_cache(cfg, B, capacity, "meta")
    specs = cache_pspecs(make_serving_rules(params.mesh, cfg), meta)
    cache = {shard_key(r): _localize(
        {"dec": {n: torch.stack([c[n] for c in cs]) for n in cs[0]}}, meta,
        specs, params.mesh, coord)
        for r, (cs, coord) in enumerate(zip(caches, params.ranks))}
    return logits[:, 0], cache


def decode_step_tp(cfg, params, cache, tokens, positions, capacity):
    """:func:`decode_step` over sharded parameters and the sharded cache of
    :func:`prefill_tp` (self K/V written in place; ``capacity`` its self
    cache's slots, :func:`~repro_torch.models.lm.seq_split`) → (logits
    [B,V] on shard 0's device, cache).  The cross memory, of
    ``enc_seq`` frames, is attended per shard (KV heads split, or whole
    on every shard) or by one partial a shard and a combine (split by
    sequence)."""
    tp = EncDecTP(cfg, params)
    B = tokens.shape[0]
    h = _tp_dec_embed(cfg, params, tp, tokens, positions[:, None])
    dcs = [cache[shard_key(r)]["dec"] for r in range(tp.tp)]
    T = dcs[0]["cross_k"].shape[2]
    # attention weights gathered whole (the ulysses strategies) over a
    # memory the rules split by KV heads: the heads that read them
    cross_view = not tp.kv_split \
        and dcs[0]["cross_k"].shape[3] != cfg.num_kv_heads
    cross_split = not (tp.kv_split or cross_view) \
        and seq_split(tp, T, cfg.enc_seq)
    valid = broadcast(torch.ones(B, T, dtype=torch.bool, device=h.device),
                      tp.devices)
    for i, ps in enumerate(_tp_stack(params, "dec_layers", cfg.num_layers)):
        x = apply_norm(cfg, ps[0]["ln1"], h)
        h = h + tp_decode_attention(
            cfg, tp, ps, x, [{"k": c["k"][i], "v": c["v"][i]} for c in dcs],
            positions, key="self_attn", capacity=capacity)
        xs = broadcast(apply_norm(cfg, ps[0]["ln2"], h), tp.devices)
        if cross_split:
            h = h + seq_split_attention(
                cfg, tp, ps, [att._project_q(cfg, p["cross_attn"], xr)
                              for p, xr in zip(ps, xs)],
                [{"k": c["cross_k"][i], "v": c["cross_v"][i]} for c in dcs],
                valid, key="cross_attn")
        else:
            cps, ctp = heads_view(cfg, ps, "cross_attn", tp) if cross_view \
                else (ps, tp)
            outs = [att.cross_decode_attention(
                cfg, p["cross_attn"], xr, c["cross_k"][i], c["cross_v"][i],
                vd, kv_runs=runs)
                for p, xr, c, vd, runs in zip(cps, xs, dcs, valid,
                                              ctp.kv_runs)]
            h = h + (reduce_sum(outs)[0] if ctp.attn_sum else outs[0])
        h = _tp_feed_forward(cfg, tp, "mlp", ps, h, norm="ln3", gated=False)
    h = apply_norm(cfg, params.shards[0]["dec_final_norm"], h)
    logits = tp_logits(cfg, [p["embed"] for p in params.shards], tp, h,
                       transpose=True)
    return logits[:, 0], cache


def _attend(cfg, tp, ps, h, seq, *, key, norm, causal=True, memory=None):
    """h + one attention sub-layer of a row in its strategy's layout:
    each shard's query rows with the whole weights (the ulysses
    strategies; ``memory`` each shard's whole cross (K, V)) or each
    shard's heads (``memory`` the encoder output whole on each shard)."""
    if LAYOUTS[tp.strategy][1]:
        return residual(cfg, tp, seq, ps, h, norm, rows=lambda xs:
                        rows_attention(cfg, ps, xs, seq, key=key,
                                       causal=causal, memory=memory))

    def attend(r, p, x, runs):
        kv = None if memory is None else tuple(att.cross_attention_cache(
            cfg, p[key], memory[r]).values())
        return att.full_attention(cfg, p[key], x, positions=seq.whole[r],
                                  causal=causal, kv=kv, kv_runs=runs)
    return residual(cfg, tp, seq, ps, h, norm, whole=lambda x:
                    heads_attention(cfg, tp, ps, x, attend, key=key,
                                    every=False))


def _mlp(cfg, tp, ps, h, seq, norm):
    """h + the non-gated MLP of a row in its strategy's layout."""
    if LAYOUTS[tp.strategy][2]:
        return residual(cfg, tp, seq, ps, h, norm, rows=lambda xs:
                        rows_mlp(cfg, ps, xs, seq, gated=False))
    return residual(cfg, tp, seq, ps, h, norm, whole=lambda x: ffn_whole(
        cfg, tp, "mlp", ps, x, gated=False))


def forward_tp(cfg, mp, batch_rows):
    """:func:`forward` of every data coordinate's row under a mesh
    (:class:`lm.MeshParams`) → per row (each shard's vocab slice of the
    logits, aux 0): the encoder's and decoder's layers one at a time
    across rows, each under remat with its leaves gathered inside
    (:func:`lm.mesh_layer`), each sub-layer in the strategy's layout
    (:data:`lm.LAYOUTS`).  Over sequence rows the encoder's queries
    attend every gathered key (no causal mask, no prefix), and the
    decoder's attend the whole memory, whose K/V each shard projects from
    its encoder rows and all-gathers; the encoder frames and the decoder
    positions split or stay whole on their own (:class:`lm.SeqSplit`)."""
    top = {p: mp.gathered(p) for p in flat_leaves(mp.tree)
           if p.split("/")[0] not in ("enc_layers", "dec_layers")}
    rows, hs = [], []
    for i, batch in enumerate(batch_rows):
        row, view = mp.row_view(i)
        tp = EncDecTP(cfg, view)
        frames = batch["encoder_frames"]
        B, T, D = frames.shape
        with on_row(row):
            enc_seq = SeqSplit(B, T, tp.devices)
            dec_seq = SeqSplit(B, batch["tokens"].shape[1], tp.devices)
            pos = torch.arange(T, dtype=torch.int32, device=frames.device)
            h = frames + sinusoidal_positions(pos, D, frames.dtype)[None]
            hs.append(enc_seq.scatter(h) if LAYOUTS[tp.strategy][0] else h)
        rows.append((row, tp, enc_seq, dec_seq))

    def enc_block(per, hs):
        out = []
        for (row, tp, seq, _), h in zip(rows, hs):
            ps = [per[c] for c in row]
            with on_row(row):
                h = _attend(cfg, tp, ps, h, seq, key="attn", norm="ln1",
                            causal=False)
                out.append(_mlp(cfg, tp, ps, h, seq, "ln2"))
        return out

    unst = {c: unstack(mp.loc_trees[c]["enc_layers"], cfg.enc_layers)
            for c in mp.coords}
    for i in range(cfg.enc_layers):
        hs = mesh_layer(cfg, mp, "enc_layers",
                        {c: unst[c][i] for c in mp.coords}, enc_block, hs)
    mems, enc_hs, hs = [], hs, []
    for (row, tp, enc_seq, dec_seq), h, batch in zip(rows, enc_hs,
                                                     batch_rows):
        with on_row(row):
            norms = [top_tree(top, "enc_final_norm", c) for c in row]
            if LAYOUTS[tp.strategy][0]:
                enc = [apply_norm(cfg, n, hr) for n, hr in zip(norms, h)]
            else:
                enc = apply_norm(cfg, norms[0], h)
            # the memory as the cross-attention reads it: each shard's
            # encoder rows (sequence rows) or the whole output (heads)
            if LAYOUTS[tp.strategy][1]:
                mems.append(enc if LAYOUTS[tp.strategy][0]
                            else enc_seq.scatter(enc))
            else:
                mems.append(broadcast(enc_seq.gather(enc)
                                      if LAYOUTS[tp.strategy][0] else enc,
                                      tp.devices))
            tokens = batch["tokens"]
            h = tp_embed(cfg, [top["embed"][c] for c in row], tp, tokens)
            h = h + sinusoidal_positions(dec_seq.whole[0], cfg.d_model,
                                         h.dtype)
            hs.append(dec_seq.scatter(h) if LAYOUTS[tp.strategy][0] else h)

    def dec_block(per, hs):
        out = []
        for (row, tp, enc_seq, seq), h, mem in zip(rows, hs, mems):
            ps = [per[c] for c in row]
            with on_row(row):
                if LAYOUTS[tp.strategy][1]:
                    kv = [att.cross_attention_cache(cfg, p["cross_attn"], m)
                          for p, m in zip(ps, mem)]
                    memory = list(zip(enc_seq.all_gather([c["k"] for c in kv]),
                                      enc_seq.all_gather([c["v"] for c in kv])))
                else:
                    memory = mem
                h = _attend(cfg, tp, ps, h, seq, key="self_attn", norm="ln1")
                h = _attend(cfg, tp, ps, h, seq, key="cross_attn", norm="ln2",
                            causal=False, memory=memory)
                out.append(_mlp(cfg, tp, ps, h, seq, "ln3"))
        return out

    unst = {c: unstack(mp.loc_trees[c]["dec_layers"], cfg.num_layers)
            for c in mp.coords}
    for i in range(cfg.num_layers):
        hs = mesh_layer(cfg, mp, "dec_layers",
                        {c: unst[c][i] for c in mp.coords}, dec_block, hs)
    out = []
    for (row, tp, _, seq), h in zip(rows, hs):
        with on_row(row):
            h = final_hidden(cfg, tp, seq, [top_tree(top, "dec_final_norm", c)
                                            for c in row], h)
            parts = logit_parts(cfg, [top["embed"][c] for c in row], tp, h,
                                transpose=True)
        out.append((parts, torch.zeros((), dtype=torch.float32,
                                       device=h.device), tp.vocab))
    return out
