"""Carry the JAX package's state into the port's objects.

Takes plain numpy arrays (``np.asarray`` of the JAX package's arrays),
never objects of that package, so the port still imports nothing of it.
With these, both packages compute on the same state in the parity tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.index import ClusterMap, FlatIndex


def cluster_map(centroids: np.ndarray, starts: np.ndarray,
                stops: np.ndarray) -> ClusterMap:
    """A cluster map from ``ClusterMap.centroids`` (C, n), ``.starts`` and
    ``.stops`` (C,) of the reference, copied."""
    return ClusterMap(centroids=np.array(centroids, np.float32),
                      starts=np.array(starts, np.int64),
                      stops=np.array(stops, np.int64))


def flat_index(embeddings: np.ndarray,
               documents: Optional[Sequence[bytes]] = None, *,
               cluster_map: Optional[ClusterMap] = None,
               epoch_rows: Optional[Sequence[int]] = None,
               device: DeviceLike = None) -> FlatIndex:
    """An index over already-normalized (and, for an IVF index, already
    permuted) embedding rows (``FlatIndex``'s ``embeddings``) and its
    documents, as they are.  ``cluster_map`` carries the reference's IVF
    layout (see `cluster_map`); ``epoch_rows`` the row count visible at
    each epoch, 0 first (the reference's ``_epoch_rows``), so views of
    earlier epochs cut the same rows and clusters."""
    index = FlatIndex.build(embeddings, documents=documents, normalize=False,
                            device=device)
    index.cluster_map = cluster_map
    if epoch_rows is not None:
        rows = [int(r) for r in epoch_rows]
        if rows[-1] != index.num_rows or rows != sorted(rows):
            raise ValueError(f"epoch rows {rows} do not end at the index's "
                             f"{index.num_rows} rows")
        index._epoch_rows = rows
        index._epoch = len(rows) - 1
    return index


def candidate_cache(params: rlwe.RlweParams, polys: np.ndarray,
                    twiddles: np.ndarray, n_dim: int, *,
                    device: DeviceLike = None) -> rlwe.CandidateCache:
    """A dense cache from ``CandidateCache.polys`` (num_docs, chunks, P, N)
    and ``.twiddles`` (P, cpt, N)."""
    dev = resolve_device(device)
    chunks, stride, cpt = rlwe._cache_geometry(params, n_dim)
    polys = np.asarray(polys, np.int32)
    if polys.shape[1:] != (chunks, params.num_primes, params.n_poly):
        raise ValueError(f"polys shape {polys.shape} does not match params")
    return rlwe.CandidateCache(
        params=params, polys=torch.from_numpy(polys).to(dev),
        twiddles=torch.from_numpy(np.asarray(twiddles, np.int32)).to(dev),
        n_dim=n_dim, num_docs=polys.shape[0], stride=stride,
        cands_per_ct=cpt, num_chunks=chunks)


def sharded_candidate_cache(params: rlwe.RlweParams, pool: np.ndarray,
                            twiddles: np.ndarray, n_dim: int,
                            config: Optional[rlwe.CandidateCacheConfig] = None,
                            *, device: DeviceLike = None
                            ) -> rlwe.ShardedCandidateCache:
    """A sharded cache over ``ShardedCandidateCache.pool`` (host, (num_docs,
    chunks, P, N)) and ``.twiddles`` (P, cpt, N) of the reference, under
    ``config`` (the reference's knobs, field for field; build it from the
    reference config's values).  The pool is copied once, so both caches
    read the same rows without sharing memory."""
    dev = resolve_device(device)
    chunks, _, _ = rlwe._cache_geometry(params, n_dim)
    pool = np.array(pool, np.int32)             # a private, writeable copy
    if pool.shape[1:] != (chunks, params.num_primes, params.n_poly):
        raise ValueError(f"pool shape {pool.shape} does not match params")
    tw = torch.from_numpy(np.asarray(twiddles, np.int32).copy()).to(dev)
    return rlwe._shard_pool(params, pool, n_dim,
                            config or rlwe.CandidateCacheConfig(), tw)


def secret_key(params: rlwe.RlweParams, s: np.ndarray, s_ntt: np.ndarray, *,
               device: DeviceLike = None) -> rlwe.RlweSecretKey:
    """A key from ``RlweSecretKey.s`` (N,) and ``.s_ntt`` (P, N)."""
    dev = resolve_device(device)
    return rlwe.RlweSecretKey(
        params=params, s=np.asarray(s, np.int8),
        s_ntt=torch.from_numpy(np.asarray(s_ntt, np.int32)).to(dev))


__all__ = ["cluster_map", "flat_index", "candidate_cache", "sharded_candidate_cache",
           "secret_key"]
