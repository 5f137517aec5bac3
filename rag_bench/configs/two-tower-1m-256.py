"""A recommender's private retrieval: the client's two towers, built in
plain PyTorch on the device from the seed and trained for a few AdamW
steps of in-batch softmax over co-click pairs (a user's first features
are the items it clicks), then the item tower's unit outputs for every
item as the corpus and the user tower's for a pool of users as the
queries.  The towers belong to the client, not to the service under
test; the reference reads a copy of the corpus the harness keeps."""

from __future__ import annotations

import numpy as np
import torch

from rag_bench.schedule import sub_seed

ROWS = 1 << 17


def _mlp(sizes, g, device):
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(d_in, d_out, generator=g, device=device) / d_in ** 0.5
        layers.append((w.requires_grad_(), torch.zeros(d_out, device=device,
                                                       requires_grad=True)))
    return layers


def _tower(table, mlp, feats):
    x = table[feats].reshape(feats.shape[0], -1)
    for j, (w, b) in enumerate(mlp):
        x = x @ w + b
        if j < len(mlp) - 1:
            x = torch.relu(x)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def make_inputs(cfg: dict, seed: int, device) -> dict:
    t = cfg["towers"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 20))
    d = t["embed_dim"]
    user = (torch.randn(t["user_vocab"], d, generator=g, device=device)
            / d ** 0.5).requires_grad_()
    item = (torch.randn(t["item_vocab"], d, generator=g, device=device)
            / d ** 0.5).requires_grad_()
    user_mlp = _mlp([t["n_user_feats"] * d] + t["tower_mlp"], g, device)
    item_mlp = _mlp([t["n_item_feats"] * d] + t["tower_mlp"], g, device)
    params = [user, item] + [p for l in user_mlp + item_mlp for p in l]
    opt = torch.optim.AdamW(params, lr=t["lr"])
    for _ in range(t["train_steps"]):
        uf = torch.randint(0, t["user_vocab"],
                           (t["train_batch"], t["n_user_feats"]),
                           generator=g, device=device)
        itf = uf[:, :t["n_item_feats"]] % t["item_vocab"]
        logits = (_tower(user, user_mlp, uf) @ _tower(item, item_mlp, itf).T
                  / t["temperature"])
        loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    del opt
    with torch.no_grad():
        feats = torch.randint(0, t["item_vocab"],
                              (cfg["num_docs"], t["n_item_feats"]),
                              generator=g, device=device)
        corpus = torch.cat([_tower(item, item_mlp, feats[i:i + ROWS])
                            for i in range(0, cfg["num_docs"], ROWS)])
        uf = torch.randint(0, t["user_vocab"],
                           (cfg["queries"]["pool"], t["n_user_feats"]),
                           generator=g, device=device)
        queries = _tower(user, user_mlp, uf)
    host = corpus.cpu().numpy()
    ref = host.copy()
    del corpus, user, item, user_mlp, item_mlp, params
    fmt = cfg["documents"].encode()
    return dict(corpus=host, queries=queries.cpu().numpy(),
                documents=[fmt % i for i in range(cfg["num_docs"])],
                reference_corpus=lambda: torch.from_numpy(ref).to(device))
