"""The paper's two baseline services (Section 4.3), PyTorch.

Counterpart of ``repro/core/baselines.py``.  Both are special cases of
RemoteRAG:
  * privacy-ignorant  = eps -> inf (no perturbation, plaintext query): the
    score-top-k kernel over the whole index, on the index's device
  * privacy-conscious = eps -> 0   (k' = N: PHE over ALL documents + OT):
    RLWE packs and scores every row (NTT and pointwise kernels on the
    index's device); Paillier runs the object path on the host, as in the
    reference
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.crypto import ot as ot_mod
from repro_torch.crypto import paillier as pai
from repro_torch.crypto import rlwe
from repro_torch.retrieval.index import FlatIndex
from repro_torch.retrieval.topk import distributed_topk


@dataclasses.dataclass
class BaselineResult:
    ids: np.ndarray
    docs: Optional[List[bytes]]
    wire_bytes: int


def privacy_ignorant_service(index: FlatIndex, e: np.ndarray, k: int,
                             *, fetch_docs: bool = True) -> BaselineResult:
    """Plaintext query up, top-k docs down. 1 round, n*beta + k*eta."""
    q = torch.as_tensor(np.asarray(e, np.float32),
                        device=index.device)[None, :]
    res = distributed_topk(index, q, k)
    ids = res.indices[0].cpu().numpy()
    docs = index.fetch_documents(ids) if fetch_docs and index.documents else None
    wire = e.size * 4 + (sum(len(d) for d in docs) if docs else 0)
    return BaselineResult(ids=ids, docs=docs, wire_bytes=wire)


def privacy_conscious_service(index: FlatIndex, e: np.ndarray, k: int,
                              *, backend: str = "paillier",
                              paillier_bits: int = 512,
                              rng: Optional[np.random.Generator] = None,
                              run_ot: bool = True) -> BaselineResult:
    """PHE distances over ALL N docs; k-out-of-N OT for retrieval.

    This is the scheme whose cost the paper reports as 2.72 h / 1.43 GB at
    N = 1e6; run it at small N and scale linearly (its cost is exactly
    linear in N by construction).
    """
    rng = rng or np.random.default_rng(0)
    rows = index.embeddings[: index.num_rows]
    wire = 0
    if backend == "paillier":
        sk = pai.keygen(paillier_bits)
        enc_q = pai.encrypt_vector(sk.pub, e)
        wire += len(enc_q) * sk.pub.ciphertext_bytes()
        enc_s = pai.encrypted_scores(sk.pub, enc_q, rows.cpu().numpy())
        wire += len(enc_s) * sk.pub.ciphertext_bytes()
        scores = pai.decrypt_scores(sk, enc_s)
    else:
        params = rlwe.RlweParams()
        sk = rlwe.keygen(params, rng, device=index.device)
        ct = rlwe.encrypt_query(sk, e, rng)
        wire += ct.c0.shape[0] * params.ciphertext_bytes()
        packed = rlwe.pack_candidates(params, rows)
        enc = rlwe.encrypted_scores(params, ct, packed)
        wire += enc.c0.shape[0] * params.ciphertext_bytes()
        scores = rlwe.decrypt_scores(sk, enc)
    order = np.argsort(-scores[: index.num_rows], kind="stable")[:k]
    docs = None
    if run_ot and index.documents:
        width = max(len(d) for d in index.documents)
        padded = [d.ljust(width, b"\x00") for d in index.documents]
        got, ot_wire = ot_mod.run_ot(padded, [int(i) for i in order])
        docs = [d.rstrip(b"\x00") for d in got]
        wire += ot_wire
    return BaselineResult(ids=np.asarray(order), docs=docs, wire_bytes=wire)


__all__ = ["BaselineResult", "privacy_ignorant_service",
           "privacy_conscious_service"]
