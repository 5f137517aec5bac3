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
    (``topk_certificate``, with the bool as ``ok``); the host waits there
    for the scan and the merge still queued before it.
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
            exact = _certificate(gidx, mi, kk)
            if late is not None:
                late["ok"] = exact
    return TopK(mv, mi, exact)


def _certificate(tile_idx: torch.Tensor, merged_idx: torch.Tensor,
                 kk: int) -> bool:
    """True iff every tile contributed < kk entries to the merged top-k."""
    num_tiles = tile_idx.shape[0]
    b = merged_idx.shape[0]
    cand = tile_idx.transpose(0, 1).reshape(b, num_tiles, kk)
    member = (cand[:, :, :, None] == merged_idx[:, None, None, :]).any(-1)
    per_tile = member.sum(-1)  # (B, num_tiles)
    return bool(torch.all(per_tile < kk))


def exact_fallback(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> TopK:
    vals, idx = _ref.topk_ref(queries, corpus, k)
    return TopK(vals, idx, True)


__all__ = ["TopK", "topk_scores", "exact_fallback"]
