"""Single-device corpus index with an epoch-versioned corpus core (PyTorch).

Counterpart of ``repro/retrieval/index.py`` without the mesh: `FlatIndex`
with ``build``, ``rows``, ``fetch_documents``, `IndexSlice` row-range
views (`plan_row_slices`), the NTT-domain ``candidate_cache`` (dense, or
the corpus-scale sharded cache under a `CandidateCacheConfig`), and the
dynamic corpus:

  * `FlatIndex.ingest` appends documents under a monotonically increasing
    epoch; every reader pins a `CorpusView` (an immutable (epoch, rows)
    snapshot), so a fixed-epoch replay is bit-identical while a writer
    appends.  Appends concatenate into a new tensor: the rows an old view
    holds are never written again.
  * `IvfConfig` runs the reference's balanced spherical k-means at build
    time and permutes the corpus so each cluster owns one contiguous row
    range (`ClusterMap`), aligned to candidate-cache shard boundaries with
    ``align``.  The k-means and the routing stay in host numpy, copied
    from the reference: they are build-time metadata, and numpy keeps the
    permutation and the map bit-identical to the reference's.

Embeddings live on the index's device (``cuda`` unless the caller asks for
``cpu``); documents stay on the host.
"""

from __future__ import annotations

import dataclasses
import threading
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
class ClusterMap:
    """IVF cluster layout over a row-permuted corpus: cluster ``c`` owns the
    contiguous global-id range ``[starts[c], stops[c])``; ``centroids``
    route queries.  Tail clusters appended by `FlatIndex.ingest` extend the
    table without touching earlier entries."""

    centroids: np.ndarray          # (C, n) float32 unit rows
    starts: np.ndarray             # (C,) int64 first global id per cluster
    stops: np.ndarray              # (C,) int64 one-past-last global id

    @property
    def num_clusters(self) -> int:
        return int(self.starts.shape[0])

    @property
    def sizes(self) -> np.ndarray:
        return self.stops - self.starts

    def route(self, queries: np.ndarray, nprobe: int) -> np.ndarray:
        """Top-``nprobe`` clusters per query by centroid score, ties broken
        (score desc, cluster id asc)."""
        q = np.asarray(queries, np.float32)
        scores = q @ self.centroids.T.astype(np.float32)      # (B, C)
        order = np.lexsort(
            (np.broadcast_to(np.arange(scores.shape[1]), scores.shape),
             -scores), axis=1)
        return order[:, :nprobe]

    def appended(self, centroid: np.ndarray, start: int,
                 stop: int) -> "ClusterMap":
        """A new map with one tail cluster ``[start, stop)`` added."""
        return ClusterMap(
            centroids=np.concatenate([self.centroids,
                                      centroid[None].astype(np.float32)]),
            starts=np.append(self.starts, start),
            stops=np.append(self.stops, stop))

    def trimmed(self, num_rows: int) -> "ClusterMap":
        """The map without the tail clusters that end past ``num_rows``
        (those appended after the epoch that held ``num_rows`` rows)."""
        if not self.stops.size or int(self.stops[-1]) <= num_rows:
            return self
        keep = int(np.searchsorted(self.stops, num_rows, side="right"))
        return ClusterMap(centroids=self.centroids[:keep],
                          starts=self.starts[:keep], stops=self.stops[:keep])


@dataclasses.dataclass(frozen=True)
class IvfConfig:
    """Build-time IVF clustering knobs (`FlatIndex.build`).  ``align`` snaps
    cluster boundaries to multiples of itself: pass the candidate cache's
    ``shard_docs`` so clusters and cache shards share boundaries."""

    num_clusters: int
    iters: int = 8
    seed: int = 0
    align: int = 1


def _kmeans_cluster_map(emb: np.ndarray, cfg: IvfConfig):
    """Balanced spherical k-means -> (row permutation, ClusterMap), the
    reference's algorithm line for line: k-means++ (D^2) seeding, ``iters``
    Lloyd steps, then capacities from `plan_row_slices` (near-equal aligned
    ranges) filled greedily, docs in decreasing best-score order each taking
    their most-preferred cluster with room left; centroids recomputed from
    the final membership."""
    num_rows, _ = emb.shape
    c_num = cfg.num_clusters
    if not (1 <= c_num <= num_rows):
        raise ValueError(
            f"num_clusters must be in [1, {num_rows}], got {c_num}")
    rng = np.random.default_rng(cfg.seed)
    centroids = np.empty((c_num, emb.shape[1]), np.float32)
    centroids[0] = emb[int(rng.integers(num_rows))]
    best = emb @ centroids[0]
    for c in range(1, c_num):
        d2 = np.maximum(1.0 - best, 0.0) ** 2
        tot = float(d2.sum())
        pick = (int(rng.choice(num_rows, p=d2 / tot)) if tot > 0
                else int(rng.integers(num_rows)))
        centroids[c] = emb[pick]
        best = np.maximum(best, emb @ centroids[c])
    for _ in range(max(0, cfg.iters)):
        assign = (emb @ centroids.T).argmax(axis=1)
        for c in range(c_num):
            members = emb[assign == c]
            if members.shape[0]:
                m = members.mean(axis=0)
                centroids[c] = m / max(np.linalg.norm(m), 1e-12)
    ranges = plan_row_slices(num_rows, c_num, align=cfg.align)
    caps = [stop - start for start, stop in ranges]
    scores = emb @ centroids.T
    pref = np.argsort(-scores, axis=1, kind="stable")
    groups: list = [[] for _ in range(c_num)]
    for d in np.argsort(-scores.max(axis=1), kind="stable"):
        for c in pref[d]:
            if len(groups[c]) < caps[c]:
                groups[c].append(int(d))
                break
    # original-id order within a cluster keeps the permutation stable
    groups = [sorted(g) for g in groups]
    perm = np.concatenate([np.asarray(g, np.int64) for g in groups])
    for c in range(c_num):
        m = emb[groups[c]].mean(axis=0)
        centroids[c] = m / max(np.linalg.norm(m), 1e-12)
    starts = np.asarray([r[0] for r in ranges], np.int64)
    stops = np.asarray([r[1] for r in ranges], np.int64)
    return perm, ClusterMap(centroids=centroids.astype(np.float32),
                            starts=starts, stops=stops)


@dataclasses.dataclass(frozen=True)
class CorpusView:
    """Immutable snapshot of the corpus at one epoch: the embedding rows a
    reader searches without touching the live index again, and the cluster
    map frozen at that epoch.  `FlatIndex.ingest` never writes the rows a
    view holds, so replaying a pinned view is bit-identical however far the
    live corpus has grown."""

    epoch: int
    embeddings: torch.Tensor       # (num_rows_at_epoch, n)
    cluster_map: Optional[ClusterMap] = None
    # per-cluster IndexSlice memo: identity state, not value state
    _slices: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def num_rows(self) -> int:
        return self.embeddings.shape[0]

    @property
    def dim(self) -> int:
        return self.embeddings.shape[1]

    def slice_view(self, start: int, stop: int) -> IndexSlice:
        """A contiguous row-range view of this snapshot."""
        return _slice(self.embeddings, start, stop, "view")

    def cluster_slice(self, c: int) -> IndexSlice:
        """The `IndexSlice` cluster ``c`` owns (memoized: repeated routed
        scans of a hot cluster never re-slice)."""
        if self.cluster_map is None:
            raise ValueError("view has no cluster map (built without ivf=)")
        sl = self._slices.get(int(c))
        if sl is None:
            sl = self.slice_view(int(self.cluster_map.starts[c]),
                                 int(self.cluster_map.stops[c]))
            self._slices[int(c)] = sl
        return sl


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
    cluster_map: Optional[ClusterMap] = None   # IVF layout (build(ivf=...))
    # NTT-domain candidate caches, memoized per (RlweParams value, config)
    # so every RemoteRagCloud over this index shares one build
    _cand_caches: dict = dataclasses.field(default_factory=dict, repr=False,
                                           compare=False)
    # epoch-versioned corpus core: `ingest` appends under `_lock` and bumps
    # `_epoch`; `_epoch_rows[e]` is the row count visible at epoch e
    _epoch: int = dataclasses.field(default=0, repr=False, compare=False)
    _epoch_rows: list = dataclasses.field(default=None, repr=False,
                                          compare=False)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def __post_init__(self):
        if self._epoch_rows is None:
            self._epoch_rows = [self.embeddings.shape[0]]

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
        """Current corpus epoch (0 at build; +1 per `ingest`)."""
        return self._epoch

    def corpus_view(self, epoch: Optional[int] = None) -> CorpusView:
        """Pin an immutable `CorpusView` at ``epoch`` (default: current),
        its cluster map without the tail clusters appended later."""
        with self._lock:
            e = self._epoch if epoch is None else int(epoch)
            if not (0 <= e <= self._epoch):
                raise ValueError(
                    f"epoch {e} out of range [0, {self._epoch}]")
            rows = self._epoch_rows[e]
            cm = self.cluster_map
            return CorpusView(
                epoch=e, embeddings=self.embeddings[:rows],
                cluster_map=None if cm is None else cm.trimmed(rows))

    @classmethod
    def build(cls, embeddings: np.ndarray, *,
              documents: Optional[Sequence[bytes]] = None,
              normalize: bool = True,
              ivf: Optional[IvfConfig] = None,
              device: DeviceLike = None) -> "FlatIndex":
        """Normalize on the host exactly as the reference does (float32
        numpy), cluster and permute the rows with ``ivf``, then place them
        on ``device``."""
        dev = resolve_device(device)
        emb = np.asarray(embeddings, np.float32)
        if normalize:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        cluster_map = None
        if ivf is not None:
            perm, cluster_map = _kmeans_cluster_map(emb, ivf)
            emb = emb[perm]
            if documents is not None:
                documents = [documents[int(i)] for i in perm]
        emb = np.ascontiguousarray(emb)
        if not emb.flags.writeable:       # e.g. a view of a JAX array
            emb = emb.copy()
        arr = torch.from_numpy(emb).to(dev)
        return cls(embeddings=arr,
                   documents=list(documents) if documents is not None else None,
                   cluster_map=cluster_map)

    def ingest(self, embeddings: np.ndarray,
               documents: Optional[Sequence[bytes]] = None, *,
               normalize: bool = True) -> CorpusView:
        """Append documents to the live corpus and advance the epoch;
        returns the new epoch's view.

        The new rows become a contiguous tail of the id space.  Every
        memoized sharded candidate cache gets their NTT plaintexts, packed
        on the index's device outside the lock, as a tail shard
        (`ShardedCandidateCache.ingest_tail`); dense caches are dropped and
        rebuild lazily from the grown corpus; an IVF index gets the tail
        range as a new cluster whose centroid is the mean of the new rows.
        The rows are appended by concatenation into a new tensor, so the
        views of earlier epochs keep theirs."""
        from repro_torch.crypto import rlwe

        emb = np.asarray(embeddings, np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(
                f"ingest embeddings must be (m, {self.dim}), got "
                f"{emb.shape}")
        if documents is not None and self.documents is None:
            raise ValueError("index was built without documents")
        if emb.shape[0] == 0:
            return self.corpus_view()
        if normalize:
            emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        new = torch.from_numpy(np.ascontiguousarray(emb)).to(self.device)
        # the expensive pack + forward NTT runs outside the lock, as the
        # cache admitter stages its copy before the atomic swap
        packed: dict = {}
        for (pk, cfg), cache in list(self._cand_caches.items()):
            if cfg is not None and pk not in packed:
                packed[pk] = rlwe._pack_corpus_ntt(cache.params, new,
                                                   host=True)
        with self._lock:
            old_rows = self.num_rows
            new_rows = old_rows + emb.shape[0]
            epoch = self._epoch + 1
            for key, cache in list(self._cand_caches.items()):
                pk, cfg = key
                if cfg is None:
                    del self._cand_caches[key]
                else:
                    cache.ingest_tail(packed[pk], epoch=epoch)
            self.embeddings = torch.cat([self.embeddings, new])
            if documents is not None:
                self.documents.extend(documents)
            if self.cluster_map is not None:
                m = emb.mean(axis=0)
                self.cluster_map = self.cluster_map.appended(
                    m / max(np.linalg.norm(m), 1e-12), old_rows, new_rows)
            self._epoch = epoch
            self._epoch_rows.append(new_rows)
        return self.corpus_view()

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


__all__ = ["ClusterMap", "CorpusView", "FlatIndex", "IndexSlice",
           "IvfConfig", "plan_row_slices"]
