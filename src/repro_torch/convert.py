"""Carry the JAX package's state into the port's objects.

Takes plain numpy arrays (``np.asarray`` of the JAX package's arrays) and
Python integers (a Paillier key's), never objects of that package, so the
port still imports nothing of it.  With these, both packages compute on
the same state in the parity tests.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.crypto import paillier as pai
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.embedder import Embedder
from repro_torch.models.transformer import Transformer, TransformerConfig
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


def paillier_public_key(n: int, g: int) -> pai.PaillierPublicKey:
    """A Paillier public key from ``PaillierPublicKey.n`` and ``.g``."""
    n, g = int(n), int(g)
    return pai.PaillierPublicKey(n=n, n_sq=n * n, g=g)


def paillier_secret_key(n: int, g: int, lam: int,
                        mu: int) -> pai.PaillierSecretKey:
    """A Paillier secret key from the reference key's ``pub.n``,
    ``pub.g``, ``lam`` and ``mu``."""
    return pai.PaillierSecretKey(pub=paillier_public_key(n, g),
                                 lam=int(lam), mu=int(mu))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(_flatten(leaf, f"{prefix}{name}."))
        else:
            out[prefix + name] = np.asarray(leaf)
    return out


def _state_dict(tree: dict, cfg: TransformerConfig) -> dict:
    """The reference's parameter tree (``embed``, ``layers`` with a leading
    (n_layers,) axis on every leaf, ``final_norm``, ``unembed``) as a
    `Transformer` state dict: ``layers.attn.wq[i]`` -> ``layers.{i}.attn.wq``."""
    state = {}
    for name, leaf in _flatten(tree).items():
        if name.startswith("layers."):
            if leaf.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: {leaf.shape[0]} stacked layers, "
                                 f"config has {cfg.n_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.n_layers):
                state[f"layers.{i}.{rest}"] = torch.from_numpy(
                    np.array(leaf[i]))
        else:
            state[name] = torch.from_numpy(np.array(leaf))
    return state


def transformer_params(tree: dict, cfg: TransformerConfig, *,
                       device: DeviceLike = None) -> Transformer:
    """A `Transformer` holding the reference's parameters: ``tree`` is the
    reference's ``init_params`` tree as nested dicts of numpy arrays.
    Every parameter must be present, at the config's shapes; a MoE tree
    (``layers.moe.{router,w_gate,w_up,w_down}``, stacked (L, ...)) must
    hold the config's padded expert count."""
    if cfg.is_moe:
        want = cfg.moe_spec.padded_experts
        moe = tree["layers"]["moe"]
        got = {name: np.shape(moe[name])[axis] for name, axis in
               (("router", 2), ("w_gate", 1), ("w_up", 1), ("w_down", 1))}
        if any(n != want for n in got.values()):
            raise ValueError(f"MoE expert axes {got}: the config pads "
                             f"{cfg.moe_experts} experts to {want}")
    model = Transformer(cfg, device=device)
    model.load_state_dict(_state_dict(tree, cfg), strict=True)
    return model


def embedder(tree: dict, cfg: TransformerConfig, *,
             device: DeviceLike = None) -> Embedder:
    """An `Embedder` holding the reference embedder's parameters (the
    reference's ``embedder.init_params`` tree, as `transformer_params`
    takes it)."""
    emb = Embedder(cfg, device=device)
    emb.model.load_state_dict(_state_dict(tree, cfg), strict=True)
    return emb


__all__ = ["cluster_map", "flat_index", "candidate_cache", "sharded_candidate_cache",
           "secret_key", "paillier_public_key", "paillier_secret_key",
           "transformer_params", "embedder"]
