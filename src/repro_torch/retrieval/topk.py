"""Exact and IVF-routed top-k' search over a corpus (PyTorch).

Counterpart of ``repro/retrieval/topk.py``: `distributed_topk` over a
`FlatIndex` or a pinned `CorpusView`, on one device or row-sharded over a
mesh (`make_sharded_topk`), `slice_topk` over an `IndexSlice`, the IVF
first stage (`cluster_topk`, `plan_nprobe`), `search_view` (the serve
layer's first-stage search) and `distances_from_scores`.  The fused score
+ select kernel reduces each scanned row range to per-tile candidates; the
small merges run outside.  A score's bits depend on its (query, row) pair
alone, in the kernel and in its plain version, so per-slice, per-cluster
and per-shard scans merged by (score desc, global id asc) equal the flat
scan bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.kernels.scoretopk import ref as sref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.retrieval.index import IndexSlice


class SearchResult(NamedTuple):
    values: torch.Tensor    # (B, k) descending scores (inner products)
    indices: torch.Tensor   # (B, k) int32 global ids
    exact: bool


def _queries(index_emb: torch.Tensor, queries) -> torch.Tensor:
    return torch.as_tensor(queries, dtype=torch.float32,
                           device=index_emb.device)


def make_sharded_topk(mesh, axes, n_rows: int, k: int, *, tile: int = 2048,
                      per_tile_k: Optional[int] = None):
    """``search(queries, shard) -> SearchResult`` over a corpus of
    ``n_rows`` rows split into contiguous blocks over ``axes`` of ``mesh``
    (`repro_torch.launch.mesh.make_mesh`); ``shard`` is this rank's block.
    Every rank of the mesh calls it in lockstep.

    The queries searched are those of the mesh's first rank, broadcast to
    every rank (a replicated input, as the reference's ``P()`` in-spec).
    Each rank reduces its block with the score-top-k kernel (on a CUDA
    block; the plain version on a CPU one) to ``k_local = min(k,
    rows_local)`` candidates per query, offsets their ids by ``position *
    rows_local``, and one all-gather over ``axes`` brings every rank's
    values, ids and exactness flag, in position order; the merge keeps
    (score desc, global id asc).  ``exact`` is the AND over the ranks.
    Ranks along axes outside ``axes`` hold the same blocks and run the same
    search.

    A rank whose block scan raises still joins the all-gather, flagged as
    failed: when every rank failed each re-raises its own error (a fault
    of the request, as in one process); when only some did, every rank
    raises `launch.mesh.MeshDivergence`."""
    axes = tuple(axes)
    n_shards = mesh_lib.axes_size(mesh, axes)
    if n_rows % n_shards:
        raise ValueError(f"{n_rows} rows do not split over {n_shards} shards")
    rows_local = n_rows // n_shards
    k_local = min(k, rows_local)
    k_out = min(k, n_shards * k_local)

    def search(queries, shard: torch.Tensor) -> SearchResult:
        if shard.shape[0] != rows_local:
            raise ValueError(f"shard holds {shard.shape[0]} rows, the mesh "
                             f"gives each {rows_local}")
        q = mesh_lib.broadcast(_queries(shard, queries), mesh)
        try:
            out = sops.topk_scores(q, shard, k_local,
                                   tile=min(tile, rows_local),
                                   per_tile_k=per_tile_k)
            gidx = out.indices + mesh_lib.axes_position(mesh, axes) * \
                rows_local
            # one collective: values, ids (int32 bits) and the flag side
            # by side
            flag = q.new_full((q.shape[0], 1), float(out.exact))
            packed = torch.cat([out.values, gidx.view(torch.float32), flag],
                               1)
            err = None
        except Exception as e:          # noqa: BLE001 — agreed below
            # this rank still joins the gather, its flag saying it failed
            packed = q.new_zeros((q.shape[0], 2 * k_local + 1))
            packed[:, -1] = -1.0
            err = e
        every = mesh_lib.all_gather(packed, mesh, axes)   # (n_shards, B, .)
        failed = (every[:, :, -1] < 0).any(1).tolist()
        if any(failed):
            if not all(failed):
                raise mesh_lib.MeshDivergence(
                    f"the block scan failed on the shards at positions "
                    f"{[p for p, f in enumerate(failed) if f]} only")
            raise err
        vals = every[..., :k_local].contiguous()
        ids = every[..., k_local:2 * k_local].contiguous().view(torch.int32)
        mv, mi = sref.merge_tiles_ref(vals, ids, k_out)
        return SearchResult(mv, mi, bool(torch.all(every[..., -1] > 0)))

    return search


def distributed_topk(index, queries, k: int, *, tile: int = 2048,
                     per_tile_k: Optional[int] = None,
                     tracer=obs.NULL_TRACER) -> SearchResult:
    """Exact top-k of <query, corpus row> over a `FlatIndex` or a
    `CorpusView`: on one device, or over the mesh a mesh-built index is
    sharded on (`make_sharded_topk`; ``num_rows`` counts the padding, as
    in the reference).  ``tracer`` reaches the one-device scan's
    certificate span; the mesh search records none."""
    if getattr(index, "mesh", None) is not None:
        search = make_sharded_topk(index.mesh, index.row_axes, index.num_rows,
                                   k, tile=tile, per_tile_k=per_tile_k)
        return search(queries, index.embeddings)
    out = sops.topk_scores(_queries(index.embeddings, queries),
                           index.embeddings, k, tile=tile,
                           per_tile_k=per_tile_k, tracer=tracer)
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


def search_view(view, queries, k: int, *, nprobe: Optional[int] = None,
                tracer=obs.NULL_TRACER) -> SearchResult:
    """The serve layer's first-stage search over a `FlatIndex` or a pinned
    `CorpusView`: with ``nprobe`` set on a corpus with a cluster map, the
    IVF-routed scan (`cluster_topk`); otherwise the exact flat scan
    (``nprobe`` is ignored without a cluster map, as in the reference).
    ``tracer`` goes to the flat scan only; the IVF scan records no
    sub-span."""
    if nprobe is not None and getattr(view, "cluster_map", None) is not None:
        return cluster_topk(view, queries, k, nprobe=nprobe)
    return distributed_topk(view, queries, k, tracer=tracer)


def distances_from_scores(values):
    """Cosine distance (paper Definition 2) from inner-product scores."""
    return 1.0 - values


__all__ = ["SearchResult", "make_sharded_topk", "distributed_topk",
           "slice_topk", "plan_nprobe", "cluster_topk", "search_view",
           "distances_from_scores"]
