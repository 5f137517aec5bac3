"""The crypto-backend seam (PyTorch): one pipeline, interchangeable crypto.

Counterpart of ``repro/crypto/backend.py``: the RLWE and Paillier
backends behind one surface, so both schemes ride the same batching,
bisection fault attribution, tracing and router scatter-gather.  Each
computes on the device its caller names: the user's for encryption and
the one-shot decryption, the cloud's for scoring, the engine's for the
batched decryption.

Method groups:

  user half      `keygen` / `encrypt_query` / `decrypt_reply`
  wire           `request_nbytes` / `reply_nbytes` / `wire_context`
  cloud half     `prepare_cloud` / `score_request` (sequential reference)
  serve batched  `cache_view` / `score_candidates` / `decrypt_scores`
"""

from __future__ import annotations

import abc
import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.crypto import paillier as pai
from repro_torch.crypto import paillier_vec as pvec
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike


class UnknownBackend(ValueError):
    """Raised for a backend name with no registered implementation."""

    def __init__(self, backend: str, known: Sequence[str]):
        self.backend = backend
        self.known = tuple(known)
        super().__init__(
            f"unknown crypto backend {backend!r}; known: {', '.join(known)}")


class CryptoBackend(abc.ABC):
    """Batched crypto operations behind one backend-neutral surface."""

    name: str

    # -- user half ----------------------------------------------------------
    @abc.abstractmethod
    def keygen(self, user) -> object:
        """Key material for a `RemoteRagUser` (reads the user's params/rng)."""

    @abc.abstractmethod
    def encrypt_query(self, user, e: np.ndarray, *,
                      tracer=obs.NULL_TRACER) -> object:
        """Encrypt one embedding under the user's key (module 2a, user
        half); ``tracer`` gets the backend's sub-spans, if it has any."""

    @abc.abstractmethod
    def decrypt_reply(self, user, enc_scores) -> np.ndarray:
        """Decrypt one reply's scores (tail of the one-shot round)."""

    # -- wire accounting ----------------------------------------------------
    @abc.abstractmethod
    def request_nbytes(self, enc_query, *, params, key_bits) -> int:
        """Wire size of an encrypted query."""

    @abc.abstractmethod
    def reply_nbytes(self, enc_scores, *, params, key_bits) -> int:
        """Wire size of a reply's score ciphertexts."""

    @abc.abstractmethod
    def wire_context(self, user) -> tuple:
        """(rlwe params | None, key_bits) for transcript accounting."""

    # -- cloud half ---------------------------------------------------------
    def prepare_cloud(self, cloud, user) -> None:
        """Hand the cloud whatever public material scoring needs."""

    @abc.abstractmethod
    def score_request(self, cloud, req, cand_ids: np.ndarray) -> object:
        """Sequential-path encrypted re-rank for one request."""

    # -- serve layer (batched) ----------------------------------------------
    def cache_view(self, cloud):
        """The candidate cache this backend scores against (None if n/a)."""
        return None

    @abc.abstractmethod
    def score_candidates(self, *, cloud, users, enc, cand_ids, kprime,
                         params, cache) -> object:
        """Batched encrypted re-rank over a lane subset; returns a score
        batch with ``.lanes()``."""

    @abc.abstractmethod
    def decrypt_scores(self, sks, stacked, *, device: DeviceLike = None,
                       tracer=obs.NULL_TRACER) -> List[np.ndarray]:
        """Batched decryption of a score batch or a per-lane list, on
        ``device`` (``cuda`` unless the caller asks for ``cpu``) where the
        keys do not fix it; ``tracer`` as in `encrypt_query`."""


class RlweBackend(CryptoBackend):
    """Batched RLWE on the device (default backend)."""

    name = "rlwe"

    def keygen(self, user):
        return rlwe.keygen(user.rlwe_params, user.rng, device=user.device)

    def encrypt_query(self, user, e, *, tracer=obs.NULL_TRACER):
        return rlwe.encrypt_query(user.sk, e, user.rng, tracer=tracer)

    def decrypt_reply(self, user, enc_scores):
        return rlwe.decrypt_scores(user.sk, enc_scores)

    def request_nbytes(self, enc_query, *, params, key_bits):
        assert params is not None
        return enc_query.c0.shape[0] * params.ciphertext_bytes()

    def reply_nbytes(self, enc_scores, *, params, key_bits):
        assert params is not None
        return enc_scores.c0.shape[0] * params.ciphertext_bytes()

    def wire_context(self, user):
        return user.rlwe_params, 2048

    def score_request(self, cloud, req, cand_ids):
        cache = cloud.candidate_cache
        if cache is not None:
            return rlwe.encrypted_scores_cached(
                cloud.rlwe_params, req.enc_query, cache, cand_ids,
                mesh=cloud.mesh)
        packed = rlwe.pack_candidates(cloud.rlwe_params,
                                      cloud.index.rows(cand_ids))
        return rlwe.encrypted_scores(cloud.rlwe_params, req.enc_query, packed)

    def cache_view(self, cloud):
        return cloud.candidate_cache

    def score_candidates(self, *, cloud, users, enc, cand_ids, kprime,
                         params, cache):
        if cache is not None:
            return rlwe.encrypted_scores_cached_batch(params, enc, cache,
                                                      cand_ids,
                                                      mesh=cloud.mesh)
        cand_rows = cloud.index.rows(cand_ids).reshape(len(users), kprime, -1)
        packed = rlwe.pack_candidates_batch(params, cand_rows)
        return rlwe.encrypted_scores_batch_stacked(
            params, enc, packed, num_cands=kprime, n_dim=cand_rows.shape[-1])

    def decrypt_scores(self, sks, stacked, *, device=None,
                       tracer=obs.NULL_TRACER):
        # the keys live on their session's device
        return rlwe.decrypt_scores_batch(sks, stacked, tracer=tracer)


@dataclasses.dataclass
class PaillierScoreBatch:
    """Per-lane Paillier score ciphertexts with the score-batch surface."""

    cts: List[list]

    def lanes(self) -> List[list]:
        return self.cts


class PaillierBackend(CryptoBackend):
    """Paper-faithful Paillier, vectorized over lanes via `paillier_vec`
    (RNS Montgomery tensor ops on the device) with per-lane object
    fallback for oversized keys.  The sequential `score_request` keeps the
    object path — it is the reference the batched path is tested
    against."""

    name = "paillier"

    def keygen(self, user):
        return pai.keygen(user.paillier_bits, rng=user._pai_rng)

    def encrypt_query(self, user, e, *, tracer=obs.NULL_TRACER):
        # no sub-spans: ``tracer`` is accepted and ignored
        return pvec.encrypt_vector(user.sk.pub, e, user._pai_rng,
                                   device=user.device)

    def decrypt_reply(self, user, enc_scores):
        return pai.decrypt_scores(user.sk, enc_scores)

    def request_nbytes(self, enc_query, *, params, key_bits):
        return len(enc_query) * 2 * key_bits // 8

    def reply_nbytes(self, enc_scores, *, params, key_bits):
        return len(enc_scores) * 2 * key_bits // 8

    def wire_context(self, user):
        return None, user.sk.pub.key_bits

    def prepare_cloud(self, cloud, user):
        cloud.register_paillier(user.sk.pub)

    def score_request(self, cloud, req, cand_ids):
        cand_rows = cloud.index.rows(cand_ids).cpu().numpy()
        return pai.encrypted_scores(cloud._paillier_pub, req.enc_query,
                                    cand_rows)

    def score_candidates(self, *, cloud, users, enc, cand_ids, kprime,
                         params, cache):
        cand_rows = cloud.index.rows(cand_ids).reshape(len(users), kprime, -1)
        return PaillierScoreBatch(pvec.encrypted_scores_batch(
            [u.sk.pub for u in users], enc, list(cand_rows),
            device=cloud.device))

    def decrypt_scores(self, sks, stacked, *, device=None,
                       tracer=obs.NULL_TRACER):
        lanes = stacked.lanes() if isinstance(stacked, PaillierScoreBatch) \
            else list(stacked)
        return pvec.decrypt_scores_batch(sks, lanes, device=device)


_REGISTRY = {b.name: b for b in (RlweBackend(), PaillierBackend())}


def get_backend(name: str) -> CryptoBackend:
    """Resolve a backend name; raises `UnknownBackend` (ValueError)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownBackend(name, sorted(_REGISTRY)) from None


def available() -> tuple:
    """Registered backend names (the launcher builds --backend from this)."""
    return tuple(sorted(_REGISTRY))


def scores_backend(enc_scores) -> CryptoBackend:
    """Structural dispatch for score ciphertexts whose wire message does
    not carry a backend tag (`protocol.Reply`)."""
    if isinstance(enc_scores, rlwe.ScoreCiphertexts):
        return _REGISTRY["rlwe"]
    return _REGISTRY["paillier"]


__all__ = ["CryptoBackend", "RlweBackend", "PaillierBackend",
           "PaillierScoreBatch", "UnknownBackend", "get_backend",
           "available", "scores_backend"]
