"""Quickstart: the RemoteRAG protocol in ~40 lines (PyTorch port).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Counterpart of ``examples/quickstart.py``: builds a small synthetic corpus,
plans the privacy budget, runs one private retrieval round, and checks the
result against the plaintext oracle.  Runs on ``cuda`` unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import protocol
from repro_torch.data import synth
from repro_torch.device import resolve_device
from repro_torch.retrieval.index import FlatIndex


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description="One private RemoteRAG round.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    dim, n_docs, k = 384, 5_000, 5

    # --- cloud side: index N documents ------------------------------------
    embeddings = synth.uniform_corpus(rng, n_docs, dim)
    documents = [f"passage #{i}".encode() for i in range(n_docs)]
    index = FlatIndex.build(embeddings, documents=documents, device=dev)

    # --- user side: pick a privacy budget, make one request ---------------
    user = protocol.RemoteRagUser(n=dim, N=n_docs, k=k, radius=0.05,
                                  backend="rlwe", rng=rng, device=dev)
    print(f"plan: eps={user.plan.eps:.0f}  k'={user.plan.kprime}  "
          f"module-2 path={user.plan.path}")

    cloud = protocol.RemoteRagCloud(index, rlwe_params=user.rlwe_params)
    query = synth.queries_near_corpus(rng, embeddings, 1)[0]

    docs, ids, transcript = protocol.run_remoterag(
        user, cloud, query, torch.Generator(device=dev).manual_seed(0))

    # --- verify against the plaintext oracle ------------------------------
    oracle = np.argsort(-(embeddings @ query), kind="stable")[:k]
    recall = len(set(ids.tolist()) & set(oracle.tolist())) / k
    print(f"retrieved ids: {ids.tolist()}")
    print(f"recall vs plaintext top-{k}: {recall:.0%}")
    print(f"wire bytes: {transcript.total_bytes:,} "
          f"(request {transcript.request_bytes:,} / "
          f"reply {transcript.reply_bytes:,})")
    assert recall == 1.0
    return recall


if __name__ == "__main__":
    main()
