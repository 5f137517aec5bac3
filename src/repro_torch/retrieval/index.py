"""Flat single-device corpus index (PyTorch).

Counterpart of the flat part of ``repro/retrieval/index.py``: `FlatIndex`
with ``build``, ``rows``, ``fetch_documents``, ``num_rows`` and the dense
NTT-domain ``candidate_cache``.  The mesh, IVF, epochs and slices of the
reference are not ported yet.  Embeddings live on the index's device
(``cuda`` unless the caller asks for ``cpu``); documents stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class FlatIndex:
    """A flat (exact-search) embedding index on one device."""

    embeddings: torch.Tensor       # (N, n) float32 unit rows
    documents: Optional[Sequence[bytes]] = None
    # dense NTT-domain candidate caches, memoized per RlweParams value so
    # every RemoteRagCloud over this index shares one build
    _cand_caches: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    @property
    def device(self) -> torch.device:
        return self.embeddings.device

    @classmethod
    def build(cls, embeddings: np.ndarray, *,
              documents: Optional[Sequence[bytes]] = None,
              normalize: bool = True,
              device: DeviceLike = None) -> "FlatIndex":
        """Normalize on the host exactly as the reference does (float32
        numpy), then place the rows on ``device``."""
        dev = resolve_device(device)
        emb = np.asarray(embeddings, np.float32)
        if normalize:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        emb = np.ascontiguousarray(emb)
        if not emb.flags.writeable:       # e.g. a view of a JAX array
            emb = emb.copy()
        arr = torch.from_numpy(emb).to(dev)
        return cls(embeddings=arr,
                   documents=list(documents) if documents is not None else None)

    def fetch_documents(self, ids: Sequence[int]):
        assert self.documents is not None, "index built without documents"
        return [self.documents[int(i)] for i in ids]

    def rows(self, ids) -> torch.Tensor:
        """Gather embedding rows by global id."""
        if not isinstance(ids, torch.Tensor):
            ids = torch.as_tensor(np.asarray(ids))
        ids = ids.to(device=self.device, dtype=torch.int64)
        return self.embeddings.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + (self.dim,))

    def candidate_cache(self, rlwe_params):
        """Dense NTT-domain candidate cache for this index under
        ``rlwe_params`` (see `repro_torch.crypto.rlwe`), built on the
        index's device on first use and memoized per params value."""
        from repro_torch.crypto import rlwe

        key = rlwe.params_key(rlwe_params)
        cache = self._cand_caches.get(key)
        if cache is None:
            cache = self._cand_caches[key] = rlwe.build_candidate_cache(
                rlwe_params, self.embeddings)
        return cache


__all__ = ["FlatIndex"]
