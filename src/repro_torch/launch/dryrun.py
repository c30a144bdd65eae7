"""The dry-run's analytic part (counterpart of ``repro/launch/dryrun.py``):
the serving KV estimates, computed from ``meta`` tensors (shapes and
dtypes, nothing allocated).

The reference's cells (``run_cell``, ``main``: lower and compile every
architecture × shape × mesh with XLA, then read its memory and cost
analyses) wait for ROADMAP A.12b; ``collective_stats`` parses XLA's HLO
and has no counterpart in the port.
"""

from __future__ import annotations

from repro_torch.models.model import Model
from repro_torch.serving.prefix_cache import tree_nbytes


def paged_kv_pool_bytes(cfg, *, num_pages: int, page_size: int) -> int:
    """Bytes the serving engine's *paged* KV pool allocates for a
    ``num_pages``-page pool: ``num_pages`` usable pages plus the reserved
    scratch page 0.  Raises ``ValueError`` for models whose KV is not
    positionally sliceable (they have no paged layout)."""
    return tree_nbytes(Model(cfg).init_paged_cache(num_pages + 1, page_size,
                                                   device="meta"))


def contiguous_kv_bytes(cfg, *, max_slots: int, max_len: int) -> int:
    """Bytes of the contiguous per-slot cache (recurrent, hybrid, int8,
    windowed and encoder-decoder models, and the dense opt-out)."""
    return tree_nbytes(Model(cfg).init_cache(max_slots, max_len,
                                             device="meta"))


def serving_kv_estimate(cfg, *, max_slots: int, max_len: int,
                        page_size: int = 16) -> dict:
    """Device-memory estimate of a decode cell's serving KV at the
    engine's default pool sizing (``num_pages = max_slots · max_len /
    page_size``), for both layouts; equal to what the engine allocates."""
    out = {
        "max_slots": max_slots,
        "max_len": max_len,
        "contiguous_bytes": contiguous_kv_bytes(
            cfg, max_slots=max_slots, max_len=max_len),
    }
    try:
        num_pages = max_slots * (max_len // page_size)
        out.update({
            "layout": "paged",
            "page_size": page_size,
            "num_pages": num_pages,
            "paged_bytes": paged_kv_pool_bytes(
                cfg, num_pages=num_pages, page_size=page_size),
        })
    except ValueError as e:  # non-sliceable KV: contiguous cache only
        out["layout"] = "contiguous"
        out["paged_unsupported"] = str(e)
    return out
