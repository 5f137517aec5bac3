"""Embedding-inversion attack proxies (paper Section 5.2 / Fig. 4).

Counterpart of ``repro/core/attacks.py``.  The paper attacks perturbed
embeddings with Vec2Text and scores SacreBLEU of the reconstruction.  No
pretrained inversion model is available offline, so we measure the same
signal — semantic recoverability as a function of the perturbation — with
two standard proxies:

  * nearest-neighbour attack: the adversary holds an auxiliary corpus of
    (tokens, embedding) pairs and decodes an observed embedding to its nearest
    auxiliary document; score = token-set F1 vs the true query tokens.
  * linear decoder attack: ridge regression from embeddings to bag-of-words
    on auxiliary data; score = F1 of the top-predicted tokens.

Both produce Fig.-4-shaped curves: near-perfect recovery at r=0 decaying to
chance as r grows, with the knee in the paper's r in [0.02, 0.1] band.

The aux embeddings, the ridge system and the decoder weights are tensors on
the attack's device.  The perturbation directions stay numpy draws from the
caller's generator, in the reference's order (radius outer, query inner, one
``rng.normal`` each), so both packages attack the same observations; the
curves draw them all first and decode them as one batch.  The nearest
neighbour's top-1 search is the port's score-top-k (kk = 1): the kernel on
the card, its plain version on the CPU, ties to the lower row id as the
reference's ``np.argmax``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.data.synth import TokenCorpus, unit
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.scoretopk import ops as scoretopk


def token_f1(pred: set, true: set) -> float:
    if not pred or not true:
        return 0.0
    tp = len(pred & true)
    if tp == 0:
        return 0.0
    precision = tp / len(pred)
    recall = tp / len(true)
    return 2 * precision * recall / (precision + recall)


def _unit_rows(observed: np.ndarray, device: torch.device) -> torch.Tensor:
    """(B, n) observations -> unit rows, normalized in float64 as the
    reference does, then float32 on ``device``."""
    obs = np.atleast_2d(np.asarray(observed, np.float64))
    return torch.from_numpy(unit(obs).astype(np.float32)).to(device)


@dataclasses.dataclass
class NearestNeighborAttack:
    """Decode an embedding to the closest auxiliary document's tokens.

    Note (EXPERIMENTS.md): a 1-NN decoder over a fixed aux corpus is the
    noise-OPTIMAL attacker — in n dims a random perturbation projects only
    ~r/sqrt(n) onto any particular neighbour direction, so this proxy needs
    ~sqrt(n)-scaled radii to degrade where Vec2Text's generative decoder
    (the paper's attack) already fails.  The privacy statement is therefore
    conservative: radii that defeat 1-NN certainly defeat Vec2Text.
    """

    aux: TokenCorpus
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.embeddings = torch.from_numpy(
            np.ascontiguousarray(self.aux.embeddings, np.float32)).to(
                self.device)

    def decode_indices(self, observed: np.ndarray) -> np.ndarray:
        """(B, n) observations -> (B,) nearest aux rows by inner product
        with the unit observation (first row on ties)."""
        top = scoretopk.topk_scores(_unit_rows(observed, self.device),
                                    self.embeddings, 1)
        return top.indices[:, 0].cpu().numpy().astype(np.int64)

    def decode_index(self, observed: np.ndarray) -> int:
        return int(self.decode_indices(observed)[0])

    def reconstruct_batch(self, observed: np.ndarray) -> List[set]:
        return [self.aux.token_sets[i] for i in self.decode_indices(observed)]

    def reconstruct(self, observed: np.ndarray) -> set:
        return self.aux.token_sets[self.decode_index(observed)]

    def score(self, observed: np.ndarray, true_tokens: set) -> float:
        return token_f1(self.reconstruct(observed), true_tokens)


@dataclasses.dataclass
class LinearDecoderAttack:
    """Ridge-regression bag-of-words decoder trained on auxiliary pairs:
    W solves the float32 system (XᵀX + λI) W = XᵀY on the device."""

    aux: TokenCorpus
    ridge: float = 1e-2
    top_m: int = 24
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        X = torch.from_numpy(np.ascontiguousarray(
            self.aux.embeddings, np.float32)).to(self.device)   # (D, n)
        sets = self.aux.token_sets
        rows = np.repeat(np.arange(len(sets)), [len(s) for s in sets])
        cols = np.fromiter(itertools.chain.from_iterable(sets), np.int64,
                           count=rows.size)
        Y = torch.zeros((X.shape[0], self.aux.vocab), dtype=torch.float32,
                        device=self.device)
        Y[torch.from_numpy(rows).to(self.device),
          torch.from_numpy(cols).to(self.device)] = 1.0
        gram = X.T @ X + self.ridge * torch.eye(
            X.shape[1], dtype=torch.float32, device=self.device)
        self.W = torch.linalg.solve(gram, X.T @ Y)       # (n, vocab)

    def reconstruct_batch(self, observed: np.ndarray) -> List[set]:
        """(B, n) observations -> the top_m tokens of each one's
        bag-of-words logits."""
        logits = _unit_rows(observed, self.device) @ self.W
        top = torch.topk(logits, self.top_m, dim=-1).indices
        return [set(row) for row in top.cpu().tolist()]

    def reconstruct(self, observed: np.ndarray) -> set:
        return self.reconstruct_batch(observed)[0]

    def score(self, observed: np.ndarray, true_tokens: set) -> float:
        return token_f1(self.reconstruct(observed), true_tokens)


def perturbed_queries(corpus: TokenCorpus, query_ids: Sequence[int],
                      radii: Sequence[float],
                      rng: np.random.Generator) -> np.ndarray:
    """(len(radii) * len(query_ids), n) float64 observations e + r·v, v a
    unit gaussian direction; drawn radius outer, query inner, one
    ``rng.normal`` each — the reference curves' order."""
    out = []
    for r in radii:
        for qi in query_ids:
            e = corpus.embeddings[qi]
            v = unit(rng.normal(size=e.shape))
            out.append(e + r * v)
    return np.asarray(out)


def attack_curve(attack, corpus: TokenCorpus, query_ids: Sequence[int],
                 radii: Sequence[float], rng: np.random.Generator) -> np.ndarray:
    """Mean attack score per perturbation radius (Fig. 4a proxy)."""
    query_ids = list(query_ids)
    obs = perturbed_queries(corpus, query_ids, radii, rng)
    preds = attack.reconstruct_batch(obs)
    truth = [corpus.token_sets[qi] for qi in query_ids] * len(radii)
    scores = np.asarray([token_f1(p, t) for p, t in zip(preds, truth)])
    return scores.reshape(len(radii), len(query_ids)).mean(axis=1)


def exact_recovery_curve(attack: NearestNeighborAttack, corpus: TokenCorpus,
                         query_ids: Sequence[int], radii: Sequence[float],
                         rng: np.random.Generator) -> np.ndarray:
    """P[attacker identifies the *literal* query document] per radius —
    the sharper privacy signal (F1 degrades gracefully through semantic
    near-duplicates; exact recovery cliffs at the decision boundary)."""
    query_ids = list(query_ids)
    obs = perturbed_queries(corpus, query_ids, radii, rng)
    hits = attack.decode_indices(obs) == np.tile(query_ids, len(radii))
    return hits.reshape(len(radii), len(query_ids)).mean(axis=1)


__all__ = ["token_f1", "NearestNeighborAttack", "LinearDecoderAttack",
           "perturbed_queries", "attack_curve", "exact_recovery_curve"]
