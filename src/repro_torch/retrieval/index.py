"""Flat single-device corpus index (PyTorch).

Counterpart of the flat part of ``repro/retrieval/index.py``: `FlatIndex`
with ``build``, ``rows``, ``fetch_documents``, the corpus ``epoch`` and
`CorpusView` snapshots, `IndexSlice` row-range views (`plan_row_slices`),
and the NTT-domain ``candidate_cache`` (dense, or the corpus-scale sharded
cache under a `CandidateCacheConfig`).  The mesh, IVF clustering and
ingestion of the reference are not ported yet (ROADMAP queue 1 item 8):
the epoch stays 0 and a view carries no cluster map.  Embeddings live on
the index's device (``cuda`` unless the caller asks for ``cpu``);
documents stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class IndexSlice:
    """A contiguous row-range view ``[start, stop)`` of an index: global
    ids are ``start + local id``, so a slice's search results drop straight
    into the parent's id space.  Documents and candidate caches stay with
    the parent index."""

    embeddings: torch.Tensor       # (stop - start, n) parent rows
    start: int
    stop: int

    @property
    def num_rows(self) -> int:
        return self.stop - self.start

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]


def plan_row_slices(num_rows: int, num_slices: int, *,
                    align: int = 1) -> list:
    """Contiguous near-equal ``(start, stop)`` row ranges covering
    ``[0, num_rows)``; ``align`` snaps interior boundaries to multiples of
    itself (pass the candidate cache's shard size so slices and cache
    shards share boundaries).  Raises if the rows cannot be cut into
    ``num_slices`` nonempty aligned ranges."""
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    if num_slices > num_rows:
        raise ValueError(f"cannot cut {num_rows} rows into {num_slices} "
                         f"nonempty slices")
    bounds = [0]
    for r in range(1, num_slices):
        cut = round(num_rows * r / num_slices / align) * align
        cut = max(cut, bounds[-1] + align)      # keep every slice nonempty
        bounds.append(cut)
    bounds.append(num_rows)
    if any(b >= e for b, e in zip(bounds[:-1], bounds[1:])):
        raise ValueError(
            f"align={align} cannot cut {num_rows} rows into {num_slices} "
            f"nonempty aligned slices")
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass(frozen=True)
class CorpusView:
    """Immutable snapshot of the corpus at one epoch: the embedding rows a
    reader searches without touching the live index again.  ``cluster_map``
    is the reference's IVF layout; the port builds no IVF index yet, so it
    is always None here, and a search that would route by it raises."""

    epoch: int
    embeddings: torch.Tensor       # (num_rows_at_epoch, n)
    cluster_map: Optional[object] = None

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def slice_view(self, start: int, stop: int) -> IndexSlice:
        """A contiguous row-range view of this snapshot."""
        return _slice(self.embeddings, start, stop, "view")


def _slice(emb: torch.Tensor, start: int, stop: int, what: str) -> IndexSlice:
    if not (0 <= start < stop <= emb.shape[0]):
        raise ValueError(f"slice [{start}, {stop}) out of range for "
                         f"{emb.shape[0]}-row {what}")
    return IndexSlice(embeddings=emb[start:stop], start=start, stop=stop)


@dataclasses.dataclass
class FlatIndex:
    """A flat (exact-search) embedding index on one device."""

    embeddings: torch.Tensor       # (N, n) float32 unit rows
    documents: Optional[Sequence[bytes]] = None
    # NTT-domain candidate caches, memoized per (RlweParams value, config)
    # so every RemoteRagCloud over this index shares one build
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

    @property
    def epoch(self) -> int:
        """Current corpus epoch: 0 until ingestion is ported."""
        return 0

    def corpus_view(self, epoch: Optional[int] = None) -> CorpusView:
        """Pin a `CorpusView` snapshot at ``epoch`` (default: current)."""
        e = self.epoch if epoch is None else int(epoch)
        if e != self.epoch:
            raise ValueError(f"epoch {e} out of range [0, {self.epoch}]")
        return CorpusView(epoch=e, embeddings=self.embeddings)

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

    def slice_view(self, start: int, stop: int) -> IndexSlice:
        """A contiguous row-range view ``[start, stop)`` of this index."""
        return _slice(self.embeddings, start, stop, "index")

    def candidate_cache(self, rlwe_params, config=None):
        """NTT-domain candidate cache for this index under ``rlwe_params``
        (see `repro_torch.crypto.rlwe`), built on first use and memoized
        per (RlweParams value, config).

        ``config=None`` builds the dense `CandidateCache` (the whole pool on
        the index's device); an `rlwe.CandidateCacheConfig` builds the
        `ShardedCandidateCache` (host pool, hot shards on the device).  The
        packed pool depends only on the params value: an existing cache for
        the same params donates it, so a new config is a re-view, never a
        re-pack."""
        from repro_torch.crypto import rlwe

        pk = rlwe.params_key(rlwe_params)
        key = (pk, config)
        cache = self._cand_caches.get(key)
        if cache is None:
            donor = next((c for (p, _), c in self._cand_caches.items()
                          if p == pk), None)
            if config is None:
                cache = (rlwe.densify_candidate_cache(donor)
                         if donor is not None else
                         rlwe.build_candidate_cache(rlwe_params,
                                                    self.embeddings))
            else:
                cache = (rlwe.shard_candidate_cache(donor, config)
                         if donor is not None else
                         rlwe.build_sharded_candidate_cache(
                             rlwe_params, self.embeddings, config=config))
            self._cand_caches[key] = cache
        return cache

    def peek_candidate_cache(self, rlwe_params, config=None):
        """The memoized cache for (params value, config) if already built,
        else None — never triggers a build."""
        from repro_torch.crypto import rlwe

        return self._cand_caches.get((rlwe.params_key(rlwe_params), config))


__all__ = ["CorpusView", "FlatIndex", "IndexSlice", "plan_row_slices"]
