"""End-to-end RemoteRAG protocol (paper Algorithms 1 + 2), PyTorch.

Counterpart of ``repro/core/protocol.py``: `RemoteRagUser` and
`RemoteRagCloud` exchange typed messages so every byte on the wire is
metered.

    user                                   cloud
    ----                                   -----
    Module 1: perturb e_k -> e_k' (DistanceDP), plan k'
    Module 2a: enc(e_k)
          -- Request{e_k', k', enc_query} -->
                                           top-k' of e_k' over the index
                                           encrypted scores of the k'
          <-- Reply{candidate_ids, enc_scores} --
    decrypt + sort -> local top-k candidate positions
    Theorem 3: omega >= delta_alpha ?
      yes -- Fetch{positions} -->          return docs        (Module 2b)
      no  -- k-of-k' OT        -->         oblivious docs     (Module 2c)

Crypto backend: "rlwe" (default) or "paillier" (paper-faithful).  Both
parties compute on their device: ``cuda`` unless the caller passes
``device="cpu"`` (the cloud computes where its index lives).  The
perturbation draws from an explicit `torch.Generator` on the user's device.

Over a mesh-built index (``FlatIndex.build(mesh=)``) every rank runs the
whole round in lockstep, the user side included (RLWE keys and
encryption from the same numpy seeds on every rank).  Each rank draws its
own perturbation on its own device; the first stage searches the mesh's
first rank's perturbed queries, broadcast to every rank
(`repro_torch.retrieval.topk.make_sharded_topk`), and the re-rank reads
the candidate cache built from the whole corpus on every rank, so every
rank returns the same result.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distancedp, planner
from repro_torch.core.planner import ProtocolPlan
from repro_torch.crypto import backend as backends
from repro_torch.crypto import ot as ot_mod
from repro_torch.crypto import paillier as pai
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.index import FlatIndex
from repro_torch.retrieval.topk import distributed_topk


# ---------------------------------------------------------------------------
# wire messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    perturbed: torch.Tensor        # e_k' (n,)
    kprime: int
    enc_query: object              # rlwe.QueryCiphertext | list[int] (paillier)
    backend: str

    def nbytes(self, params: Optional[rlwe.RlweParams] = None,
               key_bits: int = 2048) -> int:
        base = self.perturbed.numel() * 4 + 4
        return base + backends.get_backend(self.backend).request_nbytes(
            self.enc_query, params=params, key_bits=key_bits)


@dataclasses.dataclass
class Reply:
    candidate_ids: np.ndarray      # (k',) global ids (order defines positions)
    enc_scores: object             # rlwe.ScoreCiphertexts | list[int]

    def nbytes(self, params: Optional[rlwe.RlweParams] = None,
               key_bits: int = 2048) -> int:
        base = self.candidate_ids.size * 4
        return base + backends.scores_backend(self.enc_scores).reply_nbytes(
            self.enc_scores, params=params, key_bits=key_bits)


@dataclasses.dataclass
class FetchDirect:
    positions: Sequence[int]       # positions within candidate_ids (k of them)

    def nbytes(self) -> int:
        return len(self.positions) * 4


@dataclasses.dataclass
class Documents:
    docs: List[bytes]

    def nbytes(self) -> int:
        return sum(len(d) for d in self.docs)


# ---------------------------------------------------------------------------
# cloud
# ---------------------------------------------------------------------------

class RemoteRagCloud:
    """Holds the index + documents; executes modules 1, 2a, 2b, 2c on the
    index's device.  The RLWE re-rank runs against the index's NTT-domain
    candidate cache, built once per (index, params, cache config) and
    shared across clouds and engines: the dense device-resident pool by
    default, or with ``cache_config`` (an `rlwe.CandidateCacheConfig`) the
    corpus-scale `rlwe.ShardedCandidateCache` (host pool, LRU hot shards on
    the device, per-request gather of the k' selected rows).
    ``use_candidate_cache=False`` packs the candidates per request instead
    (the cold path).  All three are bit-identical.  A Paillier-only cloud
    never builds the cache.  Over a mesh index, ``mesh`` (a
    `launch.mesh.fork` of the index's mesh; default the index's own) is
    the mesh its cache gathers run on."""

    def __init__(self, index: FlatIndex, *,
                 rlwe_params: Optional[rlwe.RlweParams] = None,
                 use_candidate_cache: bool = True,
                 cache_config: Optional[rlwe.CandidateCacheConfig] = None,
                 mesh=None):
        self.index = index
        self.rlwe_params = rlwe_params or rlwe.RlweParams()
        self.use_candidate_cache = use_candidate_cache
        self.cache_config = cache_config
        self.mesh = index.mesh if mesh is None else mesh

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def candidate_cache(self):
        """The index's cache for this cloud's (params, cache config) —
        dense `rlwe.CandidateCache` or `rlwe.ShardedCandidateCache`; None
        when disabled.  Built lazily, on the first RLWE request."""
        if not self.use_candidate_cache:
            return None
        return self.index.candidate_cache(self.rlwe_params,
                                          self.cache_config)

    def handle_request(self, req: Request, *, topk_fn=None) -> Reply:
        """Modules 1 + 2a, cloud half.  ``topk_fn(perturbed_batch, kprime)``
        optionally replaces the whole-index top-k' scan."""
        q = torch.as_tensor(req.perturbed, dtype=torch.float32,
                            device=self.device)[None, :]
        if topk_fn is None:
            res = distributed_topk(self.index, q, req.kprime)
            cand_ids = res.indices[0].cpu().numpy()
        else:
            cand_ids = np.asarray(topk_fn(q, req.kprime))[0]
        enc = backends.get_backend(req.backend).score_request(
            self, req, cand_ids)
        return Reply(candidate_ids=cand_ids, enc_scores=enc)

    def register_paillier(self, pub: pai.PaillierPublicKey) -> None:
        self._paillier_pub = pub

    def handle_fetch(self, cand_ids: np.ndarray, msg: FetchDirect) -> Documents:
        ids = [int(cand_ids[p]) for p in msg.positions]
        return Documents(docs=self.index.fetch_documents(ids))

    def ot_documents(self, cand_ids: np.ndarray) -> List[bytes]:
        docs = self.index.fetch_documents([int(i) for i in cand_ids])
        width = max(len(d) for d in docs)
        return [d.ljust(width, b"\x00") for d in docs]


# ---------------------------------------------------------------------------
# user
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProtocolTranscript:
    plan: ProtocolPlan
    path: str                      # "direct" | "ot"
    request_bytes: int
    reply_bytes: int
    fetch_bytes: int
    docs_bytes: int
    ot_wire_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (self.request_bytes + self.reply_bytes + self.fetch_bytes
                + self.docs_bytes + self.ot_wire_bytes)


class RemoteRagUser:
    def __init__(self, *, n: int, N: int, k: int,
                 eps: Optional[float] = None, radius: Optional[float] = None,
                 backend: str = "rlwe",
                 rlwe_params: Optional[rlwe.RlweParams] = None,
                 paillier_bits: int = 512,
                 rng: Optional[np.random.Generator] = None,
                 plan_kwargs: Optional[dict] = None,
                 plan: Optional[ProtocolPlan] = None,
                 device: DeviceLike = None):
        self.impl = backends.get_backend(backend)   # raises UnknownBackend
        self.backend = backend
        self.device = resolve_device(device)
        self.rng = rng or np.random.default_rng(0)
        # Paillier randomness: a caller-provided rng makes key/nonce streams
        # replayable (serve parity); with no rng the scheme keeps its
        # `secrets` CSPRNG default instead of inheriting the seed-0 rng.
        self._pai_rng = rng
        # `plan` injects a precomputed plan (repeat tenants skip the
        # Theorem-1 planning, host-side scipy work)
        self.plan = plan if plan is not None else planner.plan(
            n=n, N=N, k=k, eps=eps, radius=radius, **(plan_kwargs or {}))
        self.rlwe_params = rlwe_params or rlwe.RlweParams()
        self.paillier_bits = paillier_bits
        self.sk = self.impl.keygen(self)

    # -- module 1 + 2a ------------------------------------------------------
    def encrypt_query(self, e: np.ndarray, *, tracer=obs.NULL_TRACER):
        """Encrypt the true embedding under this user's key (module 2a,
        user half).  Shared by make_request and the batched path, which
        passes its ``tracer`` for the backend's sub-spans."""
        self._e = np.asarray(e, np.float64)
        return self.impl.encrypt_query(self, self._e, tracer=tracer)

    def make_request(self, e: np.ndarray, generator: torch.Generator) -> Request:
        """``generator`` lives on the user's device and drives DistanceDP."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, user on "
                             f"{self.device}")
        pert = distancedp.perturb(generator, np.asarray(e, np.float32),
                                  self.plan.eps)
        enc = self.encrypt_query(e)
        return Request(perturbed=pert.embedding, kprime=self.plan.kprime,
                       enc_query=enc, backend=self.backend)

    # -- decrypt + sort (module 2a end) --------------------------------------
    def positions_from_scores(self, scores: np.ndarray,
                              num_candidates: int) -> np.ndarray:
        """Stable sort of decrypted scores -> local top-k positions."""
        scores = scores[: num_candidates]
        order = np.argsort(-scores, kind="stable")
        return order[: self.plan.k]

    def top_positions(self, reply: Reply) -> np.ndarray:
        scores = self.impl.decrypt_reply(self, reply.enc_scores)
        return self.positions_from_scores(scores, len(reply.candidate_ids))

    # -- module 2b / 2c ------------------------------------------------------
    def retrieve(self, cloud: RemoteRagCloud, reply: Reply,
                 positions: np.ndarray) -> tuple:
        """Returns (documents, transcript extras)."""
        if not self.plan.use_ot:
            msg = FetchDirect(positions=[int(p) for p in positions])
            docs = cloud.handle_fetch(reply.candidate_ids, msg)
            return docs.docs, dict(fetch_bytes=msg.nbytes(),
                                   docs_bytes=docs.nbytes(), ot_wire_bytes=0)
        padded = cloud.ot_documents(reply.candidate_ids)
        got, wire = ot_mod.run_ot(padded, [int(p) for p in positions])
        docs = [d.rstrip(b"\x00") for d in got]
        return docs, dict(fetch_bytes=0, docs_bytes=0, ot_wire_bytes=wire)


# ---------------------------------------------------------------------------
# one-shot round
# ---------------------------------------------------------------------------

def finish_request(user: RemoteRagUser, cloud: RemoteRagCloud, req: Request,
                   reply: Reply, positions: np.ndarray) -> tuple:
    """Module 2b/2c + accounting: retrieve the documents at ``positions``
    and assemble (docs, global ids, transcript).  Shared tail of the
    one-shot round and the batched path."""
    docs, extras = user.retrieve(cloud, reply, positions)
    params, kb = user.impl.wire_context(user)
    transcript = ProtocolTranscript(
        plan=user.plan, path=user.plan.path,
        request_bytes=req.nbytes(params, kb),
        reply_bytes=reply.nbytes(params, kb), **extras)
    ids = np.asarray([int(reply.candidate_ids[p]) for p in positions])
    return docs, ids, transcript


def run_remoterag(user: RemoteRagUser, cloud: RemoteRagCloud, e: np.ndarray,
                  generator: torch.Generator, *, topk_fn=None) -> tuple:
    """Full protocol round; returns (docs, top-k global ids, transcript)."""
    user.impl.prepare_cloud(cloud, user)
    req = user.make_request(e, generator)
    reply = cloud.handle_request(req, topk_fn=topk_fn)
    positions = user.top_positions(reply)
    return finish_request(user, cloud, req, reply, positions)


__all__ = [
    "Request", "Reply", "FetchDirect", "Documents", "RemoteRagCloud",
    "RemoteRagUser", "ProtocolTranscript", "finish_request", "run_remoterag",
]
