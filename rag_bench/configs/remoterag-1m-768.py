"""The paper's service: 10^6 unit-normal documents of width 768 and
queries near corpus rows (the harness's copy of
``synth.queries_near_corpus``), all drawn on the device from the seed.
The reference regenerates the corpus the same way, bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from rag_bench.schedule import sub_seed


def _corpus(cfg: dict, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 10))
    x = torch.randn(cfg["num_docs"], cfg["dim"], generator=g, device=device)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def make_inputs(cfg: dict, seed: int, device) -> dict:
    corpus = _corpus(cfg, seed, device)
    q = cfg["queries"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 11))
    picks = torch.randint(0, cfg["num_docs"], (q["pool"],), generator=g,
                          device=device)
    noise = torch.randn(q["pool"], cfg["dim"], generator=g,
                        device=device) * q["jitter"]
    queries = corpus[picks] + noise
    queries = queries / torch.linalg.vector_norm(queries, dim=-1,
                                                 keepdim=True)
    host = corpus.cpu().numpy()
    del corpus
    fmt = cfg["documents"].encode()
    return dict(corpus=host, queries=queries.cpu().numpy(),
                documents=[fmt % i for i in range(cfg["num_docs"])],
                reference_corpus=lambda: _corpus(cfg, seed, device))
