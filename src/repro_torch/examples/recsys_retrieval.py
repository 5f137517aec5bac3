"""Private candidate retrieval for the two-tower recsys arch (PyTorch port
of ``examples/recsys_retrieval.py``).

    PYTHONPATH=src python -m repro_torch.examples.recsys_retrieval [--device cpu]

two-tower-retrieval is the RemoteRAG-native assigned architecture: its
candidate index is a unit-norm embedding corpus, so the paper's protocol
wraps it unchanged.  The "user query" here is the *user tower output*,
exactly the sensitive object (someone's taste vector) the paper protects.

1. `train`: the reduced two-tower model (weights from a seeded
   ``torch.Generator``) for 50 AdamW steps of in-batch softmax on
   synthetic co-click pairs (the item features are the user's first
   features, as in the reference),
2. `retrieve`: index the item-tower embeddings of 4,000 items in a
   `FlatIndex`, then one private round on the RLWE backend with the
   user-tower output as the query, and recall against the plaintext
   ranking (asserted 1.0).

Runs on ``cuda`` (the port's kernels) unless given ``--device cpu`` (their
plain versions).  The items, the user and the user's keys are drawn from
one ``np.random.default_rng(0)`` in the reference's order.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import protocol
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import recsys as rec
from repro_torch.retrieval.index import FlatIndex
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer

N_ITEMS = 4_000
K = 5
STEPS, BATCH = 50, 64


def coclick_batch(cfg: rec.TwoTowerConfig, step: int, batch: int) -> tuple:
    """Step ``step``'s (user features, item features) as int32 numpy: the
    items a user clicks are its first features (mod the item vocabulary)."""
    uf = np.random.default_rng(step).integers(
        0, cfg.user_vocab, (batch, cfg.n_user_feats)).astype(np.int32)
    return uf, uf[:, :cfg.n_item_feats] % cfg.item_vocab


def train(cfg: rec.TwoTowerConfig, *, steps: int = STEPS,
          batch: int = BATCH, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None) -> tuple:
    """``steps`` AdamW steps (lr 1e-3, 5 warm-up steps) of the in-batch
    softmax; returns (the model, ``requires_grad`` off, the last loss)."""
    dev = resolve_device(device)
    model = rec.TwoTower(cfg, generator=generator, device=dev)
    model.requires_grad_(True)
    opt_cfg = opt_lib.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=steps)
    params = dict(model.named_parameters())
    state = opt_lib.init(params, opt_cfg)
    step = trainer.make_train_step(lambda p, u, i: model.loss(u, i), opt_cfg)
    m = {"loss": torch.tensor(float("nan"))}
    for s in range(steps):
        uf, itf = coclick_batch(cfg, s, batch)
        params, state, m = step(params, state, (uf, itf))
    return model.requires_grad_(False), float(m["loss"])


@torch.no_grad()
def item_embeddings(model: rec.TwoTower, item_feats: np.ndarray, *,
                    batch: int = 65_536) -> torch.Tensor:
    """The item tower over ``item_feats`` (n, n_item_feats), ``batch``
    rows a call; (n, d) float32 on the model's device."""
    return torch.cat([model.item_embedding(item_feats[i:i + batch])
                      for i in range(0, len(item_feats), batch)])


@torch.no_grad()
def retrieve(model: rec.TwoTower, *, n_items: int = N_ITEMS, k: int = K,
             rng: Optional[np.random.Generator] = None,
             generator: Optional[torch.Generator] = None,
             rlwe_params: Optional[rlwe.RlweParams] = None) -> dict:
    """Index ``n_items`` random items' tower outputs and run one private
    round (RLWE) for one random user's tower output.  Draws the items, the
    user and the user's keys from ``rng`` in that order.  Returns the
    documents, ids, transcript, decrypted scores, candidate ids, the
    plaintext top-``k`` and the recall against it, the plan, the index and
    the query."""
    cfg, dev = model.cfg, model.device
    rng = rng if rng is not None else np.random.default_rng(0)
    item_feats = rng.integers(0, cfg.item_vocab,
                              (n_items, cfg.n_item_feats)).astype(np.int32)
    item_embs = item_embeddings(model, item_feats).cpu().numpy()
    index = FlatIndex.build(
        item_embs, documents=[f"item-{i}".encode() for i in range(n_items)],
        device=dev)
    user_feats = rng.integers(0, cfg.user_vocab,
                              (1, cfg.n_user_feats)).astype(np.int32)
    taste = model.user_embedding(user_feats).cpu().numpy()[0]

    dim = item_embs.shape[1]
    user = protocol.RemoteRagUser(n=dim, N=n_items, k=k, radius=0.1,
                                  backend="rlwe", rlwe_params=rlwe_params,
                                  rng=rng, device=dev)
    cloud = protocol.RemoteRagCloud(index, rlwe_params=user.rlwe_params)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(1)
    # run_remoterag's steps, keeping the decrypted scores
    user.impl.prepare_cloud(cloud, user)
    req = user.make_request(taste, gen)
    reply = cloud.handle_request(req)
    scores = user.impl.decrypt_reply(user, reply.enc_scores)
    positions = user.positions_from_scores(scores, len(reply.candidate_ids))
    items, ids, transcript = protocol.finish_request(user, cloud, req, reply,
                                                     positions)
    oracle = np.argsort(-(item_embs @ taste), kind="stable")[:k]
    recall = len(set(ids.tolist()) & set(oracle.tolist())) / k
    return dict(items=items, ids=ids, transcript=transcript,
                scores=np.asarray(scores[:len(reply.candidate_ids)]),
                candidate_ids=np.asarray(reply.candidate_ids),
                oracle=oracle, recall=recall, kprime=user.plan.kprime,
                plan=user.plan, index=index, taste=taste)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(
        description="Private top-k item retrieval for a two-tower model.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = registry.get("two-tower-retrieval").reduced
    model, loss = train(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    print(f"two-tower trained {STEPS} steps, final in-batch loss {loss:.3f}")
    out = retrieve(model, rng=np.random.default_rng(0))
    print(f"private retrieval: items={[d.decode() for d in out['items']]}")
    print(f"recall vs plaintext ranking: {out['recall']:.0%}  "
          f"k'={out['kprime']}  "
          f"wire={out['transcript'].total_bytes / 1024:.1f} KB")
    assert out["recall"] == 1.0
    return out["recall"]


if __name__ == "__main__":
    main()
