"""Stacked-batch protocol primitives for serving (PyTorch).

Counterpart of ``repro/serve/batching.py``.  Each function is the B-query
generalization of a single-query op, built so every lane is bit-identical
to the unbatched call:

  * perturb_batch       lane b is perturb(generators[b], E[b], epss[b])
  * topk_batch          one score-top-k' kernel launch with B queries over
                        a `FlatIndex` or a pinned `CorpusView` (over a
                        mesh index: one launch per rank on its block and
                        one all-gather, every rank in lockstep)
  * encrypted_scores_cached_batch / decrypt_scores_batch
                        the RLWE cloud/user crypto with a leading batch
                        axis (re-exported from `repro_torch.crypto.rlwe`)
  * encrypted_scores_paillier_batch / decrypt_scores_paillier_batch
                        the vectorized Paillier twins (re-exported from
                        `repro_torch.crypto.paillier_vec`)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distancedp
from repro_torch.crypto import backend as crypto_backend
from repro_torch.crypto import paillier_vec
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.topk import SearchResult, search_view


def perturb_batch(generators: Sequence[torch.Generator], E: np.ndarray,
                  epss: Sequence[float], *,
                  device: DeviceLike = None) -> torch.Tensor:
    """(B,) generators + (B, n) embeddings + (B,) budgets -> (B, n) e' on
    ``device`` (``cuda`` unless the caller asks for ``cpu``); every
    generator must live there."""
    dev = resolve_device(device)
    for g in generators:
        if g.device.type != dev.type:
            raise ValueError(f"generator on {g.device}, batch on {dev}")
    E = np.asarray(E, np.float32)
    return torch.stack([distancedp.perturb(g, E[b], float(eps)).embedding
                        for b, (g, eps) in enumerate(zip(generators, epss))])


def topk_batch(index, perturbed, kprime: int, *, nprobe=None,
               tracer=obs.NULL_TRACER) -> SearchResult:
    """All B perturbed queries through the score-top-k kernel in one
    launch, on the device of ``index`` (a `FlatIndex` or an epoch-pinned
    `CorpusView`).  With ``nprobe`` set on a corpus with a cluster map the
    scan routes through `cluster_topk` (only the ``nprobe`` nearest
    clusters' slices per query); otherwise the exact flat scan, whose
    certificate ``tracer`` times (`search_view`)."""
    q = torch.as_tensor(perturbed, dtype=torch.float32,
                        device=index.embeddings.device)
    return search_view(index, q, kprime, nprobe=nprobe, tracer=tracer)


# The batched re-rank crypto lives with the scheme; re-exported here as
# the serving layer's batching surface.
pack_candidates_batch = rlwe.pack_candidates_batch
encrypted_scores_batch = rlwe.encrypted_scores_batch
encrypted_scores_batch_stacked = rlwe.encrypted_scores_batch_stacked
encrypted_scores_cached_batch = rlwe.encrypted_scores_cached_batch
decrypt_scores_batch = rlwe.decrypt_scores_batch
CandidateCacheConfig = rlwe.CandidateCacheConfig
ShardedCandidateCache = rlwe.ShardedCandidateCache
get_backend = crypto_backend.get_backend
UnknownBackend = crypto_backend.UnknownBackend
encrypted_scores_paillier_batch = paillier_vec.encrypted_scores_batch
decrypt_scores_paillier_batch = paillier_vec.decrypt_scores_batch


__all__ = ["perturb_batch", "topk_batch", "pack_candidates_batch",
           "encrypted_scores_batch", "encrypted_scores_batch_stacked",
           "encrypted_scores_cached_batch", "decrypt_scores_batch",
           "CandidateCacheConfig", "ShardedCandidateCache",
           "get_backend", "UnknownBackend",
           "encrypted_scores_paillier_batch",
           "decrypt_scores_paillier_batch"]
