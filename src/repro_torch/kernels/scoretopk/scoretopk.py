"""Wrapper of the fused score + per-tile top-k kernel (``csrc/scoretopk.cu``).

Counterpart of ``repro/kernels/scoretopk/scoretopk.py::score_topk_pallas``.
CUDA tensors only; `repro_torch.kernels.scoretopk.ops.topk_scores` routes
CPU tensors to the plain version in ``ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ext


def score_topk_cuda(queries: torch.Tensor, corpus: torch.Tensor, *, kk: int,
                    tile: int = 2048) -> tuple:
    """Fused scoring + per-tile top-kk.

    queries: (B, n), corpus: (N, n), float32 (other float types are cast).
    Returns vals (num_tiles, B, kk) float32 and global ids (num_tiles, B,
    kk) int32; slots past a tile's finite scores hold (-inf, N).
    """
    ext.require_cuda(queries, corpus)
    vals, idx = ext.extension().score_topk(
        queries.to(torch.float32).contiguous(),
        corpus.to(torch.float32).contiguous(), kk, tile)
    ext.count_launch("score_topk", (*queries.shape[:1], *corpus.shape, kk))
    return vals, idx


__all__ = ["score_topk_cuda"]
