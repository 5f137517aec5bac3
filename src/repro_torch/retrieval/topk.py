"""Exact and IVF-routed top-k' search over a single-device corpus (PyTorch).

Counterpart of ``repro/retrieval/topk.py``: `distributed_topk` (its
mesh=None branch, over a `FlatIndex` or a pinned `CorpusView`),
`slice_topk` over an `IndexSlice`, the IVF first stage (`cluster_topk`,
`plan_nprobe`), `search_view` (the serve layer's first-stage search) and
`distances_from_scores`.  The fused score + select kernel reduces each
scanned row range to per-tile candidates; the small merges run outside.
A score's bits depend on its (query, row) pair alone, in the kernel and
in its plain version, so per-slice and per-cluster scans merged by (score
desc, global id asc) equal the flat scan bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


def plan_nprobe(cluster_map, kprime: int, *, slack: float = 4.0) -> int:
    """Theorem-1 search range -> IVF probe bound: the smallest n such that
    even the n *smallest* clusters hold ``slack * kprime`` docs, clamped to
    [1, num_clusters] (the reference's rule)."""
    if kprime < 1:
        raise ValueError(f"kprime must be >= 1, got {kprime}")
    sizes = np.sort(np.asarray(cluster_map.sizes, np.int64))
    need = min(int(sizes.sum()), int(np.ceil(slack * kprime)))
    cum = np.cumsum(sizes)
    n = int(np.searchsorted(cum, need)) + 1
    return max(1, min(n, int(sizes.size)))


def cluster_topk(view, queries, k: int, *, nprobe: Optional[int] = None,
                 tile: int = 2048,
                 per_tile_k: Optional[int] = None) -> SearchResult:
    """IVF first-stage top-k over a `CorpusView` (or any object with
    ``cluster_map`` and ``cluster_slice``).

    Each query routes to its ``nprobe`` nearest clusters (host numpy,
    centroid score desc, cluster id asc); each routed cluster's slice is
    scanned once for the queries routed to it (`slice_topk`), and each
    query's candidates merge by (score desc, global id asc).  ``nprobe=None``
    (or >= the cluster count) scans every cluster and equals the flat
    `distributed_topk` scan bit for bit; a smaller ``nprobe`` skips the
    other clusters' rows, and ``exact`` is then False."""
    cm = view.cluster_map
    if cm is None:
        raise ValueError("cluster_topk needs an IVF-built corpus "
                         "(FlatIndex.build(ivf=...))")
    num_clusters = cm.num_clusters
    probe = num_clusters if nprobe is None else max(1, min(int(nprobe),
                                                           num_clusters))
    q = _queries(view.embeddings, queries)
    bsz = q.shape[0]
    routed = cm.route(q.cpu().numpy(), probe)                # (B, probe)
    if np.min(cm.sizes[routed].sum(axis=1)) < k:
        raise ValueError(
            f"nprobe={probe} routes fewer than k={k} rows; raise nprobe")
    vals = [[] for _ in range(bsz)]
    gids = [[] for _ in range(bsz)]
    exact = True
    for c in np.unique(routed):
        qsel = np.nonzero((routed == int(c)).any(axis=1))[0]
        out = slice_topk(view.cluster_slice(int(c)),
                         q[torch.from_numpy(qsel).to(q.device)], k,
                         tile=tile, per_tile_k=per_tile_k)
        exact = exact and bool(out.exact)
        ov = out.values.cpu().numpy()
        oi = out.indices.cpu().numpy()
        for j, b in enumerate(qsel):
            vals[int(b)].append(ov[j])
            gids[int(b)].append(oi[j])
    mv = np.empty((bsz, k), np.float32)
    mi = np.empty((bsz, k), np.int32)
    for b in range(bsz):
        v = np.concatenate(vals[b])
        g = np.concatenate(gids[b])
        order = np.lexsort((g, -v))[:k]     # score desc, global id asc
        mv[b] = v[order]
        mi[b] = g[order]
    return SearchResult(torch.from_numpy(mv).to(q.device),
                        torch.from_numpy(mi).to(q.device),
                        exact and probe == num_clusters)


def search_view(view, queries, k: int, *,
                nprobe: Optional[int] = None) -> SearchResult:
    """The serve layer's first-stage search over a `FlatIndex` or a pinned
    `CorpusView`: with ``nprobe`` set on a corpus with a cluster map, the
    IVF-routed scan (`cluster_topk`); otherwise the exact flat scan
    (``nprobe`` is ignored without a cluster map, as in the reference)."""
    if nprobe is not None and getattr(view, "cluster_map", None) is not None:
        return cluster_topk(view, queries, k, nprobe=nprobe)
    return distributed_topk(view, queries, k)


def distances_from_scores(values):
    """Cosine distance (paper Definition 2) from inner-product scores."""
    return 1.0 - values


__all__ = ["SearchResult", "distributed_topk", "slice_topk", "plan_nprobe",
           "cluster_topk", "search_view", "distances_from_scores"]
