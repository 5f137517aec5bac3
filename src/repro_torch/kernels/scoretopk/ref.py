"""Plain PyTorch version of the fused score + per-tile top-k kernel.

Scores are inner products (cosine similarity for unit-norm rows), in
float32 as the kernel and the TPU kernel compute them: one float32 matrix
product, never TF32 (the port leaves ``allow_tf32`` off).  Its summation
order is the BLAS library's, so it agrees with the kernel to float32
rounding.  Ties break toward the lower row id, as ``jax.lax.top_k`` does;
``torch.topk`` promises no tie order, so every selection here is a stable
descending sort over id-ordered columns.
"""

from __future__ import annotations

import torch


def score_ref(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """(B, n) x (N, n) -> (B, N) float32 inner-product scores."""
    return queries.to(torch.float32) @ corpus.to(torch.float32).T


def _select(scores: torch.Tensor, k: int) -> tuple:
    """Top-k along the last dim by (score desc, column asc)."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def topk_ref(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> tuple:
    """Exact top-k scores + indices per query: (B, k) vals, (B, k) int32."""
    vals, idx = _select(score_ref(queries, corpus), k)
    return vals, idx.to(torch.int32)


def tile_topk_ref(queries: torch.Tensor, corpus: torch.Tensor, kk: int,
                  tile: int) -> tuple:
    """Per-tile top-kk (the kernel's contract): (num_tiles, B, kk) vals and
    global int32 ids; slots past a tile's finite scores are (-inf, N)."""
    b = queries.shape[0]
    n_rows = corpus.shape[0]
    num_tiles = -(-n_rows // tile)
    pad = num_tiles * tile - n_rows
    scores = score_ref(queries, corpus)
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=-torch.inf)
    tiles = scores.reshape(b, num_tiles, tile).transpose(0, 1)
    vals, pos = _select(tiles, kk)
    offs = torch.arange(num_tiles, device=pos.device)[:, None, None] * tile
    gidx = torch.where(vals == -torch.inf, n_rows, pos + offs)
    return vals.contiguous(), gidx.to(torch.int32).contiguous()


def merge_tiles_ref(vals: torch.Tensor, gidx: torch.Tensor, k: int) -> tuple:
    """Merge per-tile candidates into the global top-k.  Candidates are laid
    out tile-major and each tile's list is (score desc, id asc), so among
    equal scores the flat position order is the id order and a stable sort
    gives (score desc, id asc)."""
    num_tiles, b, kk = vals.shape
    flat_v = vals.transpose(0, 1).reshape(b, num_tiles * kk)
    flat_i = gidx.transpose(0, 1).reshape(b, num_tiles * kk)
    mv, mpos = _select(flat_v, k)
    return mv, torch.gather(flat_i, 1, mpos)


__all__ = ["score_ref", "topk_ref", "tile_topk_ref", "merge_tiles_ref"]
