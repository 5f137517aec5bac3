"""Public API: exact top-k over a corpus with the fused kernel + certificate.

Counterpart of ``repro/kernels/scoretopk/ops.py``: the kernel for CUDA
tensors, the plain version for CPU tensors; the cross-tile merge and the
exactness certificate run outside the kernel, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels.ext import on_cuda
from repro_torch.kernels.scoretopk import ref as _ref
from repro_torch.kernels.scoretopk import scoretopk as _kern


class TopK(NamedTuple):
    values: torch.Tensor   # (B, k) scores, descending
    indices: torch.Tensor  # (B, k) int32 global row ids
    exact: bool            # certificate that the result is exact


def topk_scores(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
                tile: int = 2048, per_tile_k: int | None = None,
                tracer=obs.NULL_TRACER) -> TopK:
    """Exact top-k inner-product search.

    ``per_tile_k`` < k trades selection work for a (checked) exactness
    certificate: the merged result is exact iff no tile contributed all of
    its per-tile candidates.  Default per_tile_k = min(k, tile), always
    exact.  ``tracer`` times the certificate up to its host bool
    (``topk_certificate``, with the bool as ``ok``): a count of the merged
    entries per tile, O(B·k') plus one pass over the (num_tiles, B, kk)
    candidate ids, and the host's wait for the scan and the merge still
    queued before it.
    """
    n_rows = corpus.shape[0]
    k = min(k, n_rows)
    kk = min(per_tile_k or k, k, tile, n_rows)
    tile = min(tile, n_rows)
    if on_cuda(corpus):
        vals, gidx = _kern.score_topk_cuda(queries, corpus, kk=kk, tile=tile)
    else:
        vals, gidx = _ref.tile_topk_ref(queries, corpus, kk, tile)
    mv, mi = _ref.merge_tiles_ref(vals, gidx, k)
    exact = True
    if kk < k:
        with tracer.span("topk_certificate", lanes=queries.shape[0],
                         kprime=k) as late:
            exact = _certificate(gidx, mi, kk, tile, n_rows)
            if late is not None:
                late["ok"] = exact
    return TopK(mv, mi, exact)


def _certificate(tile_idx: torch.Tensor, merged_idx: torch.Tensor,
                 kk: int, tile: int, n_rows: int) -> bool:
    """True iff every tile contributed < kk entries to the merged top-k.

    Global ids are t·tile + row, disjoint across tiles, so a tile's share
    is a histogram of the merged ids by ``id // tile``.  The sentinel id
    ``n_rows`` (a slot past a tile's finite scores) belongs to no tile;
    where the merged list holds it, every sentinel slot of every tile
    counts as a member, as in the reference's membership test.
    """
    real = merged_idx != n_rows
    tile_of = torch.where(real, merged_idx // tile, 0).long()
    per_tile = torch.zeros(merged_idx.shape[0], tile_idx.shape[0],
                           dtype=torch.int64, device=merged_idx.device)
    per_tile.scatter_add_(1, tile_of, real.long())   # (B, num_tiles)
    sentinels = (tile_idx == n_rows).sum(-1)          # (num_tiles, B)
    per_tile += (~real).any(-1, keepdim=True) * sentinels.T
    return bool(torch.all(per_tile < kk))


def exact_fallback(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> TopK:
    vals, idx = _ref.topk_ref(queries, corpus, k)
    return TopK(vals, idx, True)


__all__ = ["TopK", "topk_scores", "exact_fallback"]
