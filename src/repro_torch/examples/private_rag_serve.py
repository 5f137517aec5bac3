"""End-to-end example: a private RAG *service* with a real embedding model
(PyTorch port of ``examples/private_rag_serve.py``).

    PYTHONPATH=src python -m repro_torch.examples.private_rag_serve [--device cpu]

1. builds the port's text embedder (mean-pooled transformer encoder, weights
   from a seeded ``torch.Generator``),
2. tokenizes and embeds a synthetic passage corpus and indexes it,
3. stands up the micro-batching `repro_torch.serve` engine with one session
   per tenant and pushes all tenants' queries through it — the cloud only
   ever sees DistanceDP-perturbed embeddings and RLWE ciphertexts, and the
   encrypted re-rank runs once per *batch* instead of once per query,
4. reports recall vs the plaintext pipeline, per-request wire bytes, and the
   engine's per-tenant latency/byte metrics.

This is the serving-kind end-to-end deliverable.  Runs on ``cuda`` (the
port's kernels) unless given ``--device cpu`` (their plain versions).  Pass
--no-batch to compare against the sequential one-query-at-a-time path, and
--trace-out trace.json to record a stage-level span timeline viewable at
https://ui.perfetto.dev — spans carry only sizes/shard ids/tenant ids, never
query-derived payloads.  A request's DistanceDP key is an integer seed of
its generator.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.crypto import rlwe
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import resolve_device
from repro_torch.models.embedder import Embedder, encoder_config
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import AdmissionError, EngineConfig, ServeEngine

DIM = 256
N_DOCS = 2_000
SEQ = 32
K = 5
VOCAB = 8192
EMBED_BATCH = 50            # passages embedded per call
TOPICS = ["weather storm rain wind", "finance stock bond market",
          "health doctor medicine flu", "sports game team score",
          "music concert guitar song", "travel flight hotel beach"]
QUERIES = ["rain and storms this weekend", "stock market crash bond",
           "flu medicine from the doctor"]


def make_passages(rng: np.random.Generator, n_docs: int) -> list:
    """Synthetic passages with topical token structure: passage i is topic
    i mod 6 plus 12 random words w0..w499 from ``rng``."""
    passages = []
    for i in range(n_docs):
        t = TOPICS[i % len(TOPICS)]
        extra = " ".join(f"w{rng.integers(0, 500)}" for _ in range(12))
        passages.append(f"{t} {extra}")
    return passages


def embed_texts(model: Embedder, tok: HashTokenizer, texts, seq: int,
                batch: int = EMBED_BATCH) -> np.ndarray:
    """Tokenize at ``seq`` and embed ``batch`` texts per call; float32
    (len(texts), d_model) on the host."""
    ids = tok.encode_batch(texts, seq)
    return np.concatenate([model.embed(ids[i:i + batch]).cpu().numpy()
                           for i in range(0, len(ids), batch)])


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="End-to-end private RAG service over the repro_torch.serve "
                    "micro-batching engine.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--no-batch", action="store_true",
                    help="run the sequential one-query-at-a-time comparison "
                         "path instead of micro-batching")
    ap.add_argument("--no-candidate-cache", action="store_true",
                    help="disable the NTT-domain candidate cache: the cloud "
                         "re-packs + forward-NTTs the k' candidates on every "
                         "request (cold reference path; bit-identical "
                         "results)")
    ap.add_argument("--cache-shard-docs", type=int, default=None,
                    metavar="DOCS",
                    help="serve the re-rank from the sharded corpus-scale "
                         "cache with DOCS documents per shard (host-pooled "
                         "shards + per-request gather of only the k' "
                         "selected candidates) instead of the dense "
                         "device-resident cache")
    ap.add_argument("--cache-budget-mb", type=float, default=None,
                    metavar="MB",
                    help="device-memory budget for LRU-pinned hot shards of "
                         "the sharded cache (0 = stream-only, no pinning; "
                         "default: unbounded).  Implies --cache-shard-docs' "
                         "sharded mode when set")
    ap.add_argument("--sync-admission", action="store_true",
                    help="sharded cache: use the deterministic legacy "
                         "admission mode (synchronous first-touch LRU, "
                         "copy in the request path) instead of the default "
                         "async frequency-aware admitter (2nd-touch policy, "
                         "background H2D copy, engine prefetch overlap)")
    ap.add_argument("--rounds", type=int, default=1, metavar="N",
                    help="submit the query set N times (default 1).  With "
                         "hot sharded-cache shards (e.g. --cache-shard-docs "
                         "1000 --rounds 2), repeat rounds cross the "
                         "2nd-touch admission threshold, so a traced run "
                         "shows the background shard admissions overlapping "
                         "the encrypt stage on the timeline")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable stage-level tracing and write a Perfetto-"
                         "loadable Chrome-trace JSON timeline to PATH "
                         "(spans carry only structural fields)")
    return ap


def main(argv=None, *, model: Optional[Embedder] = None) -> list:
    """Serve the example's queries; returns the engine's results (request
    order).  ``model`` replaces the seeded embedder (its config must be
    ``encoder_config(dim=256, vocab=8192, n_layers=2)``), e.g. with
    weights carried across by `repro_torch.convert.embedder`."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)

    cache_config = None
    if args.cache_shard_docs is not None or args.cache_budget_mb is not None:
        budget = (None if args.cache_budget_mb is None
                  else int(args.cache_budget_mb * 2**20))
        cache_config = rlwe.CandidateCacheConfig(
            shard_docs=args.cache_shard_docs, max_resident_bytes=budget,
            async_admission=not args.sync_admission)

    rng = np.random.default_rng(0)
    tok = HashTokenizer(vocab_size=VOCAB)
    cfg = encoder_config(dim=DIM, vocab=VOCAB, n_layers=2)
    if model is None:
        model = Embedder(cfg, generator=torch.Generator().manual_seed(0),
                         device=dev)
    if model.cfg != cfg or model.device != dev:
        raise ValueError(f"embedder {model.cfg.name} on {model.device}, "
                         f"the example needs {cfg.name} on {dev}")

    passages = make_passages(rng, N_DOCS)
    print(f"embedding {N_DOCS} passages with {cfg.name} ...")
    embs = embed_texts(model, tok, passages, SEQ)
    index = FlatIndex.build(embs, documents=[p.encode() for p in passages],
                            device=dev)

    engine = ServeEngine(index, config=EngineConfig(
        max_batch=4, sequential=args.no_batch,
        use_candidate_cache=not args.no_candidate_cache,
        cache_config=cache_config,
        trace=args.trace_out is not None))

    tenants = [f"user-{i}" for i in range(len(QUERIES))]
    for t in tenants:
        engine.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05,
                            backend="rlwe")
    plan = engine.sessions.get(tenants[0]).plan
    cache = engine.sessions.plan_cache
    print(f"plan: k'={plan.kprime}, path={plan.path} "
          f"(plan cache: {cache.hits} hits / {cache.misses} misses)")

    q_all = embed_texts(model, tok, QUERIES, SEQ, batch=1)
    embedded = list(zip(tenants, QUERIES, q_all))
    q_embs = {}
    for rnd in range(max(args.rounds, 1)):
        for qi, (tenant, qtext, q_emb) in enumerate(embedded):
            # typed backpressure: with admission control configured a
            # submit can be rejected (RateLimited, QueueFull, ...) — a
            # client reports it and keeps serving the rest of its queue
            try:
                rid = engine.submit(tenant, q_emb,
                                    key=rnd * len(embedded) + qi)
            except AdmissionError as e:
                print(f"rejected ({type(e).__name__}): {qtext!r}")
                continue
            q_embs[rid] = (qtext, q_emb)
    results = engine.drain()

    for res in results:
        if res.shed_reason is not None:
            print(f"shed ({res.shed_reason}): request {res.request_id} "
                  f"for tenant {res.tenant}")
            continue
        assert res.ok, f"dispatch failed: {res.error}"
        qtext, q_emb = q_embs[res.request_id]
        oracle = np.argsort(-(embs @ q_emb), kind="stable")[:K]
        recall = len(set(res.ids.tolist()) & set(oracle.tolist())) / K
        if res.request_id < len(embedded):   # print the first round only
            print(f"\nquery: {qtext!r}  (tenant {res.tenant}, "
                  f"batch of {res.batch_size})")
            print(f"  top doc: {res.docs[0][:60]!r}")
            print(f"  recall={recall:.0%}  "
                  f"wire={res.transcript.total_bytes/1024:.1f} KB  "
                  f"path={res.transcript.path}")
        assert recall == 1.0

    agg = engine.metrics.summary()["aggregate"]
    print(f"\nengine: {agg['count']} requests, "
          f"p50={agg['p50_latency_s']}s p99={agg['p99_latency_s']}s, "
          f"mean batch {agg['mean_batch_size']}")
    stats = engine.cache_stats()
    if stats is not None:
        print(f"sharded cache: {stats['hits']} shard hits / "
              f"{stats['misses']} misses, "
              f"resident {stats['resident_bytes'] / 2**20:.1f} MiB "
              f"(peak {stats['peak_resident_bytes'] / 2**20:.1f}) "
              f"of {stats['pool_bytes'] / 2**20:.1f} MiB pool")
        print(f"admission: {stats['admissions']} total "
              f"({stats['async_admissions']} async, "
              f"{stats['pending_admissions']} in flight), "
              f"{stats['prefetches']} prefetched touches, "
              f"{stats['policy_deferrals']} deferred below threshold, "
              f"{stats['admit_dropped']} dropped at the queue cap")
    if args.trace_out is not None:
        stages = engine.tracer.stage_summary()
        n_events = engine.write_trace(args.trace_out)
        print(f"trace: {n_events} spans over stages "
              f"{sorted(stages)} -> {args.trace_out} "
              f"(load at https://ui.perfetto.dev)")
    # release the sharded cache's background admitter thread
    engine.close()
    return results


if __name__ == "__main__":
    main()
