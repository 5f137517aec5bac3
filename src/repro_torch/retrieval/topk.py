"""Exact top-k' search over a single-device `FlatIndex` (PyTorch).

Counterpart of ``repro/retrieval/topk.py``: `distributed_topk` (its
mesh=None branch), `slice_topk` and `distances_from_scores`.  The fused
score + select kernel reduces the corpus to per-tile candidates; the small
cross-tile merge runs outside.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.retrieval.index import FlatIndex


class SearchResult(NamedTuple):
    values: torch.Tensor    # (B, k) descending scores (inner products)
    indices: torch.Tensor   # (B, k) int32 global ids
    exact: bool


def _queries(index_emb: torch.Tensor, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=index_emb.device)


def distributed_topk(index: FlatIndex, queries, k: int, *,
                     tile: int = 2048,
                     per_tile_k: Optional[int] = None) -> SearchResult:
    """Exact top-k of <query, corpus row> over the index (one device)."""
    out = sops.topk_scores(_queries(index.embeddings, queries),
                           index.embeddings, k, tile=tile,
                           per_tile_k=per_tile_k)
    return SearchResult(out.values, out.indices, out.exact)


def slice_topk(embeddings: torch.Tensor, start: int, queries, k: int, *,
               tile: int = 2048,
               per_tile_k: Optional[int] = None) -> SearchResult:
    """Exact top-k over a contiguous row slice ``embeddings`` whose first
    row has global id ``start``; ids come back global.  Same tile schedule
    and (score desc, id asc) order as the full-index path."""
    rows = embeddings.shape[0]
    out = sops.topk_scores(_queries(embeddings, queries), embeddings,
                           min(k, rows), tile=min(tile, rows),
                           per_tile_k=per_tile_k)
    return SearchResult(out.values, out.indices + start, out.exact)


def distances_from_scores(values):
    """Cosine distance (paper Definition 2) from inner-product scores."""
    return 1.0 - values


__all__ = ["SearchResult", "distributed_topk", "slice_topk",
           "distances_from_scores"]
