"""Shared small settings for the harness's CPU tests."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_RLWE = {"n_poly": 1024, "num_primes": 3, "t_bits": 28,
              "scale_q_bits": 13, "scale_c_bits": 13, "eta": 8,
              "chunk": 512}
SMALL_RAG = {"num_docs": 2000, "dim": 64, "rlwe": SMALL_RLWE,
             "queries": {"pool": 64, "jitter": 0.15},
             "engine": {"max_batch": 4, "max_wait_s": 0.02, "refill": True,
                        "tenants": 3, "candidate_cache": "dense"}}
SMALL_TOWER = {**SMALL_RAG, "dim": 16, "queries": {"pool": 64},
               "towers": {"embed_dim": 16, "tower_mlp": [32, 16],
                          "user_vocab": 500, "item_vocab": 500,
                          "n_user_feats": 3, "n_item_feats": 2,
                          "train_steps": 3, "train_batch": 64, "lr": 1e-3,
                          "temperature": 0.05}}
