"""Exact top-k' search over a single-device `FlatIndex` (PyTorch).

Counterpart of ``repro/retrieval/topk.py``: `distributed_topk` (its
mesh=None branch, over a `FlatIndex` or a pinned `CorpusView`),
`slice_topk` over an `IndexSlice`, `search_view` (the flat branch of the
serve layer's search) and `distances_from_scores`.  The fused score +
select kernel reduces the corpus to per-tile candidates; the small
cross-tile merge runs outside.  IVF routing (`cluster_topk`,
`plan_nprobe`) is not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.retrieval.index import IndexSlice


class SearchResult(NamedTuple):
    values: torch.Tensor    # (B, k) descending scores (inner products)
    indices: torch.Tensor   # (B, k) int32 global ids
    exact: bool


def _queries(index_emb: torch.Tensor, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=index_emb.device)


def distributed_topk(index, queries, k: int, *, tile: int = 2048,
                     per_tile_k: Optional[int] = None) -> SearchResult:
    """Exact top-k of <query, corpus row> over a `FlatIndex` or a
    `CorpusView` (one device)."""
    out = sops.topk_scores(_queries(index.embeddings, queries),
                           index.embeddings, k, tile=tile,
                           per_tile_k=per_tile_k)
    return SearchResult(out.values, out.indices, out.exact)


def slice_topk(sl: IndexSlice, queries, k: int, *, tile: int = 2048,
               per_tile_k: Optional[int] = None) -> SearchResult:
    """Exact top-k over one row slice, in *global* ids: the same tile
    schedule and (score desc, id asc) order as the full-index path, then
    local ids offset by ``sl.start``."""
    out = sops.topk_scores(_queries(sl.embeddings, queries), sl.embeddings,
                           min(k, sl.num_rows), tile=min(tile, sl.num_rows),
                           per_tile_k=per_tile_k)
    return SearchResult(out.values, out.indices + sl.start, out.exact)


def search_view(view, queries, k: int, *,
                nprobe: Optional[int] = None) -> SearchResult:
    """The serve layer's first-stage search over a `FlatIndex` or a pinned
    `CorpusView`: the exact flat scan.  ``nprobe`` is ignored on a corpus
    without a cluster map, as in the reference; a corpus with one would
    route through IVF, which is not ported, so it raises rather than
    silently scanning flat."""
    if getattr(view, "cluster_map", None) is not None:
        raise NotImplementedError(
            "IVF first-stage routing (cluster_topk) is not ported yet "
            "(ROADMAP queue 1 item 8)")
    return distributed_topk(view, queries, k)


def distances_from_scores(values):
    """Cosine distance (paper Definition 2) from inner-product scores."""
    return 1.0 - values


__all__ = ["SearchResult", "distributed_topk", "slice_topk", "search_view",
           "distances_from_scores"]
