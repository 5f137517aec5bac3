"""Synthetic corpora standing in for MS MARCO + real embedding models.

Counterpart of the uniform part of ``repro/data/synth.py`` (numpy, copied):
the paper's theory (Lemma 1) models the corpus as uniform on S^{n-1}.  The
clustered and token corpora wait for a later slice.
"""

from __future__ import annotations

from typing import List

import numpy as np


def unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def uniform_corpus(rng: np.random.Generator, n_docs: int, dim: int) -> np.ndarray:
    return unit(rng.normal(size=(n_docs, dim)).astype(np.float32))


def queries_near_corpus(rng: np.random.Generator, corpus: np.ndarray,
                        n_queries: int, *, jitter: float = 0.15) -> np.ndarray:
    """Queries correlated with corpus rows (realistic retrieval workload)."""
    picks = rng.integers(0, corpus.shape[0], size=n_queries)
    noise = rng.normal(size=(n_queries, corpus.shape[1])) * jitter
    return unit(corpus[picks] + noise).astype(np.float32)


def passages(rng: np.random.Generator, n_docs: int,
             avg_bytes: int = 1024) -> List[bytes]:
    """MS-MARCO-like passage payloads (sized for eta-unit accounting)."""
    lens = np.maximum(rng.poisson(avg_bytes, size=n_docs), 16)
    return [bytes(rng.integers(97, 123, size=l, dtype=np.uint8)) for l in lens]


__all__ = ["unit", "uniform_corpus", "queries_near_corpus", "passages"]
