"""Batched multi-tenant serving engine for the RemoteRAG protocol (PyTorch).

Counterpart of ``repro/serve`` without the scale-out router (ROADMAP queue
1 item 8).  Layers (bottom up):

  batching.py   stacked-batch primitives: DistanceDP perturbation,
                batched score-top-k' over the pinned corpus view, batched
                RLWE scoring / decryption with per-tenant keys.
  session.py    per-tenant state: keys, protocol plan (PlanCache).
  admission.py  SLO-aware admission tier (typed rejections, token buckets,
                priority-classed queues, deadline-aware shedding).
  engine.py     micro-batching request engine: size/deadline/refill
                triggers, batched and sequential dispatch, lane-level
                fault isolation with a background retry lane.
  metrics.py    per-tenant latency percentiles + wire-byte accounting.

The batched path is bit-compatible with the one-query `run_remoterag`
round, and with the reference engine given the same perturbed inputs:
identical docs, ids and wire bytes (tests/test_torch_engine.py).
"""

from repro_torch.serve.admission import (
    PRIORITIES,
    AdmissionConfig,
    AdmissionController,
    AdmissionError,
    InvalidEmbedding,
    QueueFull,
    RateLimited,
    UnknownTenant,
)
from repro_torch.serve.batching import (CandidateCacheConfig,
                                        ShardedCandidateCache)
from repro_torch.serve.engine import EngineConfig, ServeEngine, ServeResult
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.session import PlanCache, Session, SessionManager

__all__ = [
    "EngineConfig", "ServeEngine", "ServeResult", "ServeMetrics",
    "PlanCache", "Session", "SessionManager",
    "CandidateCacheConfig", "ShardedCandidateCache",
    "PRIORITIES", "AdmissionConfig", "AdmissionController",
    "AdmissionError", "UnknownTenant", "InvalidEmbedding", "QueueFull",
    "RateLimited",
]
