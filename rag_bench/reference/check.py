"""The comparison that decides ``correct``, and its lower-precision
control.

For a sample of the requests a run finished, drawn from the seed, the
reference works out again what the program derived:

* ``cand_gap``: the perturbed query (``dp``) and its top-k' over the
  corpus (float32 scan, rescored in float64).  The number is the widest
  gap by which the lowest of the program's k' candidates lies below the
  reference's k'-th best score; a candidate list of another length, with
  repeats or ids outside the corpus reads infinite.
* ``topk_gap``: the k ids chosen among the program's candidates by the
  encrypted scoring and decryption.  The number is the widest gap by
  which a served id's true score (float64 inner product with the query)
  lies below the k-th best true score of the candidates; ids outside the
  candidates, or another count than k, read infinite.
* ``doc_errors``: requests whose documents are not those of their ids.
* ``wire_errors``: requests whose transcript differs from the wire
  formula (``wire``) in any field.

The control is this reference put in the program's place in bfloat16,
the precision below the configuration's float32: the first stage and the
true scores computed from bfloat16 rows and queries, read by the same
numbers."""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import dp, wire

SCAN_ROWS = 1 << 17


@dataclasses.dataclass
class Served:
    """One finished request as the harness saw it."""
    query: np.ndarray                   # (n,) float32, the true embedding
    key: int                            # its DistanceDP key
    cand_ids: Optional[np.ndarray]      # the reply's candidate ids
    ids: np.ndarray                     # the served ids
    docs: List[bytes]
    transcript: Optional[dict]          # the ProtocolTranscript's fields


def scan_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
              dtype=torch.float32) -> torch.Tensor:
    """Ids (S, k) of the top-k rows of ``corpus`` for each query, scores
    computed in ``dtype`` (float32 with TF32 off, or bfloat16), row block
    by row block."""
    q = queries.to(dtype)
    best_v = best_i = None
    for start in range(0, corpus.shape[0], SCAN_ROWS):
        block = corpus[start:start + SCAN_ROWS].to(dtype)
        s = q @ block.T
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + start
        if best_v is not None:
            v = torch.cat([best_v, v], dim=1)
            i = torch.cat([best_i, i], dim=1)
            v, j = torch.topk(v, min(k, v.shape[1]), dim=1)
            i = torch.gather(i, 1, j)
        best_v, best_i = v, i
    return best_i


def _scores64(corpus: torch.Tensor, ids, q: torch.Tensor) -> torch.Tensor:
    ids_t = torch.as_tensor(np.asarray(ids, np.int64), device=corpus.device)
    return corpus.index_select(0, ids_t).double() @ q.double()


def _valid(ids, count: int, n_rows: int) -> bool:
    ids = np.asarray(ids)
    return (ids.ndim == 1 and ids.shape[0] == count
            and np.unique(ids).shape[0] == count
            and bool(np.all((ids >= 0) & (ids < n_rows))))


def perturbed(served: Sequence[Served], eps: float,
              device) -> torch.Tensor:
    return torch.stack([dp.perturb(s.key, s.query, eps, device)
                        for s in served])


def gaps(corpus: torch.Tensor, served: Sequence[Served], pert: torch.Tensor,
         *, k: int, kprime: int) -> dict:
    """``cand_gap`` and ``topk_gap`` (widest over ``served``) of the
    candidate lists and served ids in ``served``."""
    with _fp32_exact():
        margin = max(32, kprime // 50)
        top = scan_topk(pert, corpus, kprime + margin)
        n_rows = corpus.shape[0]
        cand_gap = topk_gap = 0.0
        for s, p, t in zip(served, pert, top):
            ref = torch.topk(_scores64(corpus, t.cpu().numpy(), p), kprime)
            kth = float(ref.values[-1])
            if s.cand_ids is None or not _valid(s.cand_ids, kprime, n_rows):
                cand_gap = topk_gap = math.inf
                continue
            sp = _scores64(corpus, s.cand_ids, p)
            cand_gap = max(cand_gap, kth - float(sp.min()))
            q = torch.as_tensor(np.asarray(s.query, np.float32),
                                device=corpus.device)
            true = _scores64(corpus, s.cand_ids, q)
            pos = {int(c): j for j, c in enumerate(s.cand_ids)}
            ids = [int(i) for i in np.asarray(s.ids).reshape(-1)]
            if len(ids) != k or len(set(ids)) != k or any(
                    i not in pos for i in ids):
                topk_gap = math.inf
                continue
            kth_true = float(torch.topk(true, k).values[-1])
            served_min = float(true[[pos[i] for i in ids]].min())
            topk_gap = max(topk_gap, kth_true - served_min)
    return dict(cand_gap=max(cand_gap, 0.0), topk_gap=max(topk_gap, 0.0))


def document_errors(served: Sequence[Served], doc_format: str) -> int:
    return sum(
        list(s.docs) != [(doc_format % int(i)).encode()
                                for i in np.asarray(s.ids).reshape(-1)]
        for s in served)


def wire_errors(served: Sequence[Served], *, dim: int, kprime: int, k: int,
                doc_format: str, rlwe: dict) -> int:
    bad = 0
    for s in served:
        want = wire.transcript(
            dim=dim, kprime=kprime, k=k,
            docs=[(doc_format % int(i)).encode()
                  for i in np.asarray(s.ids).reshape(-1)],
            n_poly=rlwe["n_poly"], num_primes=rlwe["num_primes"],
            chunk=rlwe["chunk"])
        bad += s.transcript != want
    return bad


def control(corpus: torch.Tensor, served: Sequence[Served],
            pert: torch.Tensor, *, k: int, kprime: int,
            dtype=torch.bfloat16) -> List[Served]:
    """The reference in the program's place at ``dtype`` (the control:
    bfloat16): each request's candidates and served ids from scores in
    that precision."""
    cand = scan_topk(pert, corpus, kprime, dtype=dtype)
    out = []
    for s, c in zip(served, cand):
        q = torch.as_tensor(np.asarray(s.query, np.float32),
                            device=corpus.device).to(dtype)
        rows = corpus.index_select(0, c).to(dtype)
        pick = torch.topk(rows @ q, k).indices
        out.append(dataclasses.replace(
            s, cand_ids=c.cpu().numpy(), ids=c[pick].cpu().numpy()))
    return out


class _fp32_exact:
    """Float32 matrix products without TF32 inside the block."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False
