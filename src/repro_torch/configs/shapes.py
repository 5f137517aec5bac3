"""Assigned input-shape sets, per architecture family.

Every (arch x shape) pair is one dry-run cell.  LM ``decode_*`` / ``long_*``
shapes lower `serve_step` (one token against a KV cache), not `train_step`.
Graph sizes are padded up to multiples of 1024 so every mesh shard is even.

Counterpart of ``repro/configs/shapes.py``, copied whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _pad(x: int, to: int = 1024) -> int:
    return -(-x // to) * to


@dataclasses.dataclass(frozen=True)
class LmShape:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k": LmShape("train_4k", "train", 4096, 256),
    "prefill_32k": LmShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": LmShape("decode_32k", "decode", 32768, 128),
    "long_500k": LmShape("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    kind: str              # "full" | "minibatch" | "batched_small"
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_nodes: Optional[int] = None
    fanout: Optional[Tuple[int, ...]] = None


GNN_SHAPES = {
    # cora-scale full batch (2708 /10556 padded)
    "full_graph_sm": GraphShape("full_graph_sm", "full",
                                _pad(2708), _pad(10556), 1433),
    # reddit-scale sampled training: static upper bounds for fanout 15-10
    # seeds 1024 -> <=1024*15 L1 edges -> <=15360*10 L2 edges
    "minibatch_lg": GraphShape("minibatch_lg", "minibatch",
                               _pad(1024 * (1 + 15 + 150)),   # 170k nodes
                               _pad(1024 * 15 + 15360 * 10),  # 169k edges
                               512, batch_nodes=1024, fanout=(15, 10)),
    "ogb_products": GraphShape("ogb_products", "full",
                               _pad(2_449_029), _pad(61_859_140), 100),
    # 128 graphs x (30 nodes, 64 edges), flattened with block-diag edges
    "molecule": GraphShape("molecule", "batched_small",
                           _pad(30 * 128), _pad(64 * 128), 32),
}


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    kind: str              # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: Optional[int] = None


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", "train", 65_536),
    "serve_p99": RecsysShape("serve_p99", "serve", 512),
    "serve_bulk": RecsysShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecsysShape("retrieval_cand", "retrieval", 1,
                                  n_candidates=1_000_000),
}


@dataclasses.dataclass(frozen=True)
class RagShape:
    name: str
    kind: str              # "module1" | "module2"
    corpus: int = 0
    dim: int = 768
    batch: int = 1
    kprime: int = 160


REMOTERAG_SHAPES = {
    # Module 1: plaintext top-k' scoring over the sharded corpus
    "module1_1m": RagShape("module1_1m", "module1", corpus=2 ** 20, dim=768,
                           batch=32, kprime=160),
    # Module 2a: batched encrypted re-ranking (256 concurrent requests)
    "module2_b256": RagShape("module2_b256", "module2", batch=256,
                             dim=768, kprime=160),
}


__all__ = ["LmShape", "LM_SHAPES", "GraphShape", "GNN_SHAPES",
           "RecsysShape", "RECSYS_SHAPES", "RagShape", "REMOTERAG_SHAPES"]
