"""Synthetic corpora standing in for MS MARCO + real embedding models.

Counterpart of ``repro/data/synth.py`` (numpy, copied): the paper's theory
(Lemma 1) models the corpus as uniform on S^{n-1}; the clustered corpus is
a mixture of spherical clusters (topical corpora, the workload the IVF
first stage exists for); in the token corpus documents are token multisets
over a vocabulary and the embedding is a normalized random projection of the
tf vector, so embeddings carry recoverable token signal (what the Fig.-4
inversion-attack proxies in `repro_torch.core.attacks` need).  Every draw
is made in the reference's order, so a seed gives the same corpus in both
packages, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


def unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def uniform_corpus(rng: np.random.Generator, n_docs: int, dim: int) -> np.ndarray:
    return unit(rng.normal(size=(n_docs, dim)).astype(np.float32))


def clustered_corpus(rng: np.random.Generator, n_docs: int, dim: int,
                     *, n_clusters: int = 64,
                     concentration: float = 6.0) -> np.ndarray:
    """Mixture of spherical clusters: center + gaussian/concentration, renorm."""
    centers = unit(rng.normal(size=(n_clusters, dim)))
    assign = rng.integers(0, n_clusters, size=n_docs)
    noise = rng.normal(size=(n_docs, dim)) / np.sqrt(concentration * dim)
    return unit(centers[assign] + noise).astype(np.float32)


@dataclasses.dataclass
class TokenCorpus:
    embeddings: np.ndarray        # (n_docs, dim) unit rows
    token_sets: List[set]         # per-doc token ids
    documents: List[bytes]        # rendered docs
    projection: np.ndarray        # (vocab, dim) — the "embedding model"
    vocab: int

    def embed_tokens(self, tokens) -> np.ndarray:
        tf = np.zeros(self.vocab, np.float32)
        for t in tokens:
            tf[t] += 1.0
        v = tf @ self.projection
        return v / (np.linalg.norm(v) + 1e-9)


def token_corpus(rng: np.random.Generator, n_docs: int, dim: int,
                 *, vocab: int = 4096, doc_len: int = 24,
                 zipf_a: float = 1.3,
                 paraphrases: int = 0, swap_frac: float = 0.3) -> TokenCorpus:
    """``paraphrases`` > 0 groups documents into near-duplicate clusters
    (each base doc plus `paraphrases` variants with ~swap_frac tokens swapped)
    — the dense-semantic-neighbourhood structure real corpora have, which is
    what makes embedding-inversion degrade *gracefully* with perturbation
    radius (paper Fig. 4) instead of cliff-dropping at the NN distance.

    Draw order (the reference's): the projection, then per base document
    its zipf tokens, then per paraphrase its swapped positions and their
    zipf tokens."""
    projection = rng.normal(size=(vocab, dim)).astype(np.float32) / np.sqrt(dim)
    token_lists = []
    while len(token_lists) < n_docs:
        base = np.minimum(rng.zipf(zipf_a, size=doc_len) - 1, vocab - 1)
        token_lists.append(base)
        for i in range(min(paraphrases, n_docs - len(token_lists))):
            var = base.copy()
            # graded distances: 1, 2, 3... token swaps (embedding distance
            # ~ sqrt(2*(k)/doc_len) — the near-duplicate shell)
            n_swap = min(1 + i % max(1, int(swap_frac * doc_len)), doc_len)
            idx = rng.choice(doc_len, n_swap, replace=False)
            var[idx] = np.minimum(rng.zipf(zipf_a, size=n_swap) - 1, vocab - 1)
            token_lists.append(var)
    token_sets, documents, embs = [], [], []
    for toks in token_lists[:n_docs]:
        token_sets.append(set(int(t) for t in toks))
        documents.append((" ".join(f"tok{t}" for t in sorted(token_sets[-1])))
                         .encode())
        tf = np.bincount(toks, minlength=vocab).astype(np.float32)
        embs.append(tf @ projection)
    embeddings = unit(np.asarray(embs, np.float32))
    return TokenCorpus(embeddings=embeddings, token_sets=token_sets,
                       documents=documents, projection=projection, vocab=vocab)


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


__all__ = ["unit", "uniform_corpus", "clustered_corpus", "TokenCorpus",
           "token_corpus", "queries_near_corpus", "passages"]
