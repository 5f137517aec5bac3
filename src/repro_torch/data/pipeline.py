"""Deterministic, seekable, shard-aware batch pipeline.

Requirements at scale: (1) each data-parallel shard reads disjoint data;
(2) any batch is reproducible from (seed, step) alone — checkpoint restart
replays exactly (see train/fault.ResumableRun); (3) no host state to lose.

Everything derives from counter-based RNG: batch(step) = f(seed, step), so
the pipeline is random-access rather than an iterator with hidden position.

Counterpart of ``repro/data/pipeline.py``, copied: batches are numpy
arrays, bit-identical to the reference's for every (seed, step); the
caller moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LmSyntheticTask:
    """Token-prediction task over a synthetic markovian stream (real lowering
    path, deterministic, no corpus files)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        # block-markov stream: mixes uniform tokens with repeated motifs so
        # the LM loss actually decreases during smoke training
        b, s = self.global_batch, self.seq_len
        base = rng.integers(4, self.vocab, size=(b, s), dtype=np.int32)
        motif = rng.integers(4, self.vocab, size=(b, 8), dtype=np.int32)
        reps = np.tile(motif, (1, s // 8 + 1))[:, :s]
        mask = rng.random((b, s)) < 0.5
        tokens = np.where(mask, reps, base).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        return tokens, targets


@dataclasses.dataclass(frozen=True)
class ClickSyntheticTask:
    """CTR-style task for the recsys archs: clicks correlate with a sparse
    latent preference so AUC is learnable."""

    n_sparse: int
    vocab_per_field: int
    global_batch: int
    n_dense: int = 0
    seed: int = 0

    def batch(self, step: int):
        rng = np.random.default_rng((self.seed, step))
        b = self.global_batch
        ids = rng.integers(0, self.vocab_per_field,
                           size=(b, self.n_sparse), dtype=np.int32)
        ids += np.arange(self.n_sparse, dtype=np.int32) * self.vocab_per_field
        logit = ((ids % 7 == 0).sum(-1) - self.n_sparse / 7.0) * 1.5
        labels = (rng.random(b) < 1 / (1 + np.exp(-logit))).astype(np.float32)
        if self.n_dense:
            dense = rng.normal(size=(b, self.n_dense)).astype(np.float32)
            return dense, ids, labels
        return ids, labels


def host_shard(array: np.ndarray, shard: int, num_shards: int) -> np.ndarray:
    """Row-slice a global batch for this host (multi-host data loading)."""
    per = array.shape[0] // num_shards
    return array[shard * per:(shard + 1) * per]


__all__ = ["LmSyntheticTask", "ClickSyntheticTask", "host_shard"]
