"""Model facade: one object per architecture config, dispatching to the
family implementation (:mod:`.lm` for the decoder-only families,
:mod:`.encdec` for the encoder-decoder)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.device import resolve_device

from . import encdec, lm
from .common import abstract_tree, axes_tree, init_tree


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    @property
    def is_encdec(self) -> bool:
        return self.cfg.family == "enc_dec"

    def schema(self) -> dict:
        if self.is_encdec:
            return encdec.encdec_schema(self.cfg)
        return lm.lm_schema(self.cfg)

    def init(self, seed=0, *, device="cuda", dtype=None) -> dict:
        """Random parameters from a ``torch.Generator`` made on ``device``
        and seeded with ``seed`` (or a generator passed in its place).
        ``dtype`` defaults to the config's ``param_dtype``."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        dt = dtype or torch_dtype(self.cfg.param_dtype)
        with torch.no_grad():
            return init_tree(gen, self.schema(), dt, dev)

    def abstract_params(self, dtype=None) -> dict:
        """The parameter tree as ``meta`` tensors (shapes and dtypes, no
        storage) in ``dtype`` (a torch dtype or a config dtype name;
        default the config's ``param_dtype``)."""
        dt = dtype or self.cfg.param_dtype
        return abstract_tree(self.schema(),
                             torch_dtype(dt) if isinstance(dt, str) else dt)

    def param_logical_axes(self) -> dict:
        """Each parameter leaf's logical axis names (the sharding rules'
        input)."""
        return axes_tree(self.schema())

    def num_params(self) -> int:
        def count(tree):
            return sum(count(v) if isinstance(v, dict)
                       else int(torch.Size(v.shape).numel())
                       for v in tree.values())
        return count(self.schema())

    # -- compute -------------------------------------------------------------

    def forward(self, params, batch):
        """→ (logits [B,S,V], aux_loss).  An encoder-decoder batch holds
        ``encoder_frames`` [B, enc_seq, D] beside ``tokens``."""
        if self.is_encdec:
            return encdec.forward(self.cfg, params, batch)
        return lm.forward(self.cfg, params, batch)

    def loss_fn(self, params, batch):
        """Next-token loss of the reference (``repro/models/model.py``):
        mean NLL + 1e-4·mean(logsumexp²) (z-loss) + 1e-2·aux (the MoE
        layers' Switch loss), in float32 → (loss, {"nll", "aux",
        "zloss"})."""
        logits, aux = self.forward(params, batch)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["targets"].long()[..., None])[..., 0]
        nll = (logz - gold).mean()
        zloss = 1e-4 * logz.square().mean()
        loss = nll + zloss + 1e-2 * aux
        return loss, {"nll": nll, "aux": aux, "zloss": zloss}

    def loss_tp(self, mp, batch_rows):
        """:meth:`loss_fn` of every data coordinate's row under a mesh
        (:class:`lm.MeshParams`; ``batch_rows[i]`` row i's batch slice)
        over vocab-sharded logits → per row (loss, {"nll", "aux",
        "zloss"}) on the row's first shard's device."""
        fwd = encdec.forward_tp if self.is_encdec else lm.forward_tp
        out = []
        for (parts, aux, split), batch in zip(
                fwd(self.cfg, mp, batch_rows), batch_rows):
            nll, zloss = lm.vocab_loss(self.cfg, parts, batch["targets"],
                                       split)
            aux = aux.to(nll.device)
            out.append((nll + zloss + 1e-2 * aux,
                        {"nll": nll, "aux": aux, "zloss": zloss}))
        return out

    def prefill(self, params, batch, capacity, *, prefix=None,
                prefix_len=None, last_index=None):
        """→ (last_logits [B,V], cache); see :func:`lm.prefill` and
        :func:`encdec.prefill`."""
        if self.is_encdec:
            if prefix is not None or last_index is not None:
                raise ValueError(
                    "prefix-aware prefill is not supported for enc_dec")
            return encdec.prefill(self.cfg, params, batch, capacity)
        if prefix is not None and self.prefix_seq_axes() is None:
            raise ValueError(
                f"{self.cfg.name}: KV is not positionally sliceable — "
                f"prefix-aware prefill unsupported")
        return lm.prefill(self.cfg, params, batch, capacity, prefix=prefix,
                          prefix_len=prefix_len, last_index=last_index)

    def prefix_seq_axes(self):
        """Sequence axis of each serving-cache leaf, or None when
        per-position KV reuse is unsound: recurrent/hybrid state is not
        positionally sliceable, windowed attention uses ring buffers and
        int8 KV would make cached and cold prefills differ, and an
        encoder-decoder's cache holds cross-attention memory.  Such
        models are served from the contiguous cache.  The cache leaves of
        the attention-only families (dense, MoE and VLM) are ``[L, B, T,
        KVH, hd]``: axis 2."""
        if self.is_encdec:
            return None
        lm.check_family(self.cfg)
        if lm.is_contiguous(self.cfg):
            return None
        return {"k": 2, "v": 2}

    # -- contiguous KV ----------------------------------------------------------

    def init_cache(self, batch, capacity, *, device="cuda"):
        """Grouped contiguous decode cache for ``batch`` sequences of up to
        ``capacity`` positions (ring buffers of ``min(capacity, window)``
        slots for windowed attention); see :func:`lm.init_cache` and
        :func:`encdec.init_cache`."""
        if self.is_encdec:
            return encdec.init_cache(self.cfg, batch, capacity,
                                     resolve_device(device))
        return lm.init_cache(self.cfg, batch, capacity,
                             resolve_device(device))

    def decode_step(self, params, cache, tokens, positions, *,
                    capacity=None):
        """tokens [B,1], positions [B] → (logits [B,V], cache updated in
        place) over the grouped contiguous cache (an encoder-decoder's
        ``{"dec": ...}`` cache).  ``capacity``, the positions the cache was
        made for, tells a sharded step (:class:`ShardedParams`) a cache
        that every shard holds whole from one split by sequence; the
        one-device step does not read it."""
        if self.is_encdec:
            return encdec.decode_step(self.cfg, params, cache, tokens,
                                      positions, capacity)
        return lm.decode_step(self.cfg, params, cache, tokens, positions,
                              capacity)

    # -- paged KV -------------------------------------------------------------

    def init_paged_cache(self, num_pages, page_size, *, device="cuda"):
        """Block-paged KV pool: leaves [L, num_pages, page_size, KVH, hd]."""
        if self.prefix_seq_axes() is None:
            raise ValueError(
                f"{self.cfg.name}: KV is not positionally sliceable — "
                f"paged layout unsupported")
        return lm.init_paged_cache(self.cfg, num_pages, page_size,
                                   resolve_device(device))

    def decode_step_paged(self, params, cache, tokens, positions,
                          page_table):
        """tokens [B,1], positions [B], page_table [B,N] int32 →
        (logits [B,V], cache updated in place)."""
        return lm.decode_step_paged(self.cfg, params, cache, tokens,
                                    positions, page_table)


def build_model(cfg) -> Model:
    return Model(cfg)
