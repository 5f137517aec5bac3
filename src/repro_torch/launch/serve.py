"""Serving launcher: the private RAG service end to end (PyTorch port).

Counterpart of ``repro/launch/serve.py``.  Builds a synthetic corpus +
FlatIndex on the device, spins up the micro-batching `repro_torch.serve`
engine with a pool of tenant sessions, and serves a stream of queries
through the full protocol (Module 1 DistanceDP + range limitation, Module
2a encrypted re-rank, Module 2b/2c retrieval), printing latency and
wire-size stats per request plus the engine metrics, one JSON object per
line.

`python -m repro_torch.launch.serve --n-docs 20000 --requests 8`
`... --device cpu` runs the plain PyTorch path on the CPU (the default is
``cuda``, which launches the port's CUDA kernels).
`... --no-batch` runs the sequential one-query-at-a-time comparison path.
`... --backend paillier` serves with the paper's Paillier scheme (512-bit
keys; the vectorized RNS Montgomery crypto on the device).
`... --replicas N` serves through the scale-out `ReplicaRouter` (N engine
replicas over contiguous corpus slices, scatter-gather top-k'; results
bit-identical to one engine) and prints the router summary.
`... --corpus clustered --ivf-clusters C --nprobe N|auto` builds the IVF
first stage (k-means at build, cluster-contiguous rows) and scans N
clusters per query (`auto`: the planner-derived bound, `plan_nprobe`).
`... --ingest D` ingests D new documents after the first wave (tail-shard
append, epoch advance), refreshes (or, with replicas, re-plans) and serves
the stream again at the new epoch.
`... --trace-out trace.json` enables stage-level span tracing and writes a
Chrome-trace timeline loadable at https://ui.perfetto.dev.

Admission control (off unless one of these is set): `--tenant-rate R`,
`--max-queue N`, `--deadline-ms MS`, `--priority CLASS`, as in the
reference.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.crypto import backend as crypto_backend
from repro_torch.data import synth
from repro_torch.device import resolve_device
from repro_torch.retrieval.index import FlatIndex, IvfConfig
from repro_torch.retrieval.topk import plan_nprobe
from repro_torch.serve import (AdmissionConfig, AdmissionError, EngineConfig,
                               RateLimited, ReplicaRouter, RouterConfig,
                               ServeEngine)
from repro_torch.serve.admission import PRIORITIES
from repro_torch.serve.session import PlanCache, SessionManager


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--radius", type=float, default=0.05)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--backend", choices=crypto_backend.available(),
                    default="rlwe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernels) or cpu (the "
                         "plain PyTorch path)")
    ap.add_argument("--corpus", choices=("uniform", "clustered"),
                    default="uniform")
    ap.add_argument("--ivf-clusters", type=int, default=None, metavar="C",
                    help="build the index with C-cluster IVF first-stage "
                         "routing (k-means at build, cluster-aligned row "
                         "layout); replica slices then land on cluster "
                         "boundaries")
    ap.add_argument("--nprobe", default=None, metavar="N|auto",
                    help="clusters scanned per query (needs "
                         "--ivf-clusters): an integer, or 'auto' for the "
                         "planner-derived Theorem-1 bound (plan_nprobe on "
                         "the session plan's k'); N >= C is bit-identical "
                         "to the flat scan")
    ap.add_argument("--ingest", type=int, default=None, metavar="D",
                    help="after the first wave, ingest D new docs (tail-"
                         "shard append, epoch advance), refresh/replan, "
                         "and serve the stream again at the new epoch")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--no-batch", action="store_true",
                    help="sequential comparison path (one query per step)")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="N > 1 serves through a ReplicaRouter: N engine "
                         "replicas over contiguous corpus slices with "
                         "scatter-gather top-k' (bit-identical to N=1); "
                         "prints the router summary")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable stage tracing and write a Perfetto-"
                         "loadable Chrome-trace JSON timeline to PATH")
    ap.add_argument("--tenant-rate", type=float, default=None, metavar="R",
                    help="per-tenant token-bucket rate limit in "
                         "requests/s (enables the admission tier)")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="bound the global request queue at N")
    ap.add_argument("--deadline-ms", type=float, default=None, metavar="MS",
                    help="default per-request SLO budget (deadline-aware "
                         "shedding before any crypto)")
    ap.add_argument("--priority", choices=PRIORITIES, default=None,
                    help="default admission priority class")
    args = ap.parse_args(argv)
    if args.tenants < 1 or args.requests < 1:
        ap.error("--tenants and --requests must be >= 1")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.replicas > 1 and args.no_batch:
        ap.error("--replicas > 1 is the batched path; drop --no-batch")
    if args.ivf_clusters is not None and args.ivf_clusters < 1:
        ap.error("--ivf-clusters must be >= 1")
    if args.nprobe is not None and args.ivf_clusters is None:
        ap.error("--nprobe needs --ivf-clusters")
    device = resolve_device(args.device)
    print(json.dumps({"device": {
        "type": device.type,
        "name": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu")}}))

    rng = np.random.default_rng(0)
    gen = (synth.uniform_corpus if args.corpus == "uniform"
           else synth.clustered_corpus)
    emb = gen(rng, args.n_docs, args.dim)
    docs = synth.passages(rng, args.n_docs, avg_bytes=256)
    ivf = (IvfConfig(num_clusters=args.ivf_clusters)
           if args.ivf_clusters is not None else None)
    index = FlatIndex.build(emb, documents=docs, ivf=ivf, device=device)
    # IVF builds permute rows into cluster-contiguous order, so result ids
    # live in the index's row space: score recall against that
    emb = index.embeddings.cpu().numpy()

    nprobe = None
    if args.nprobe is not None:
        if args.nprobe == "auto":
            # the Theorem-1 probe bound for this session shape: enough
            # clusters that the planned k'-row search range is covered
            plan = PlanCache().get(n=args.dim, N=args.n_docs, k=args.k,
                                   radius=args.radius)
            nprobe = plan_nprobe(index.cluster_map, plan.kprime)
        else:
            nprobe = int(args.nprobe)
    if ivf is not None:
        print(json.dumps({"ivf": {
            "clusters": index.cluster_map.num_clusters,
            "nprobe": nprobe if nprobe is not None else "all"}}))

    admission = None
    if (args.tenant_rate is not None or args.max_queue is not None
            or args.deadline_ms is not None or args.priority is not None):
        admission = AdmissionConfig(
            tenant_rate=args.tenant_rate,
            max_queue=args.max_queue,
            default_deadline_s=(None if args.deadline_ms is None
                                else args.deadline_ms / 1e3),
            default_priority=args.priority or "interactive")
    ecfg = EngineConfig(
        max_batch=1 if args.no_batch else args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        sequential=args.no_batch,
        trace=args.trace_out is not None,
        admission=admission,
        nprobe=nprobe)
    # context manager: close() drains leftovers and joins the sharded
    # cache's admitter and the retry lane (no thread outlives the engine);
    # the router also stops its per-replica worker pools
    sessions = SessionManager(device=device)
    service = (ReplicaRouter(index, config=RouterConfig(
                   num_replicas=args.replicas, engine=ecfg),
                   sessions=sessions)
               if args.replicas > 1 else
               ServeEngine(index, config=ecfg, sessions=sessions))
    with service as engine:
        for t in range(args.tenants):
            sess = engine.open_session(f"tenant-{t}", n=args.dim,
                                       N=args.n_docs, k=args.k,
                                       radius=args.radius,
                                       backend=args.backend)
        plan = sess.plan
        print(json.dumps({"plan": {
            "eps": plan.eps, "kprime": plan.kprime, "path": plan.path,
            "radius": plan.radius,
            "plan_cache": {"hits": engine.sessions.plan_cache.hits,
                           "misses": engine.sessions.plan_cache.misses}}}))

        queries = synth.queries_near_corpus(rng, emb, args.requests)
        t0 = time.monotonic()
        rejected = 0
        rid_to_query = {}
        for i, q in enumerate(queries):
            tenant = f"tenant-{i % args.tenants}"
            # typed backpressure: a rejected submit is reported and the
            # loop continues — the client never dies on overload
            try:
                rid = engine.submit(tenant, q, key=i)
            except AdmissionError as e:
                rejected += 1
                rec = {"request": None, "tenant": tenant,
                       "rejected": type(e).__name__}
                if isinstance(e, RateLimited):
                    rec["retry_after_s"] = round(e.retry_after_s, 3)
                print(json.dumps(rec))
                continue
            rid_to_query[rid] = q
        results = engine.drain()
        wall = time.monotonic() - t0

        for res in results:
            if res.shed_reason is not None:  # admission-tier shed, no crypto
                print(json.dumps({
                    "request": res.request_id, "tenant": res.tenant,
                    "latency_s": round(res.latency_s, 3),
                    "shed": res.shed_reason}))
                continue
            if not res.ok:  # lane failed after its quarantine retry
                print(json.dumps({
                    "request": res.request_id, "tenant": res.tenant,
                    "latency_s": round(res.latency_s, 3),
                    "quarantined": res.quarantined,
                    "error": res.error}))
                continue
            q = rid_to_query[res.request_id]
            plain = np.argsort(-(emb @ q), kind="stable")[: args.k]
            recall = (len(set(res.ids.tolist()) & set(plain.tolist()))
                      / args.k)
            print(json.dumps({
                "request": res.request_id, "tenant": res.tenant,
                "latency_s": round(res.latency_s, 3),
                "batch_size": res.batch_size, "recall": recall,
                "wire_bytes": res.transcript.total_bytes,
                "path": res.transcript.path}))
        if args.replicas > 1:
            fleet = engine.summary()
            fleet["router"]["qps"] = round(len(results) / wall, 3)
            print(json.dumps(fleet))
        else:
            summary = engine.metrics.summary()
            summary["aggregate"]["qps"] = round(len(results) / wall, 3)
            occupancy = engine.metrics.occupancy(engine.config.max_batch)
            out = {"summary": summary["aggregate"],
                   "num_batches": summary["num_batches"],
                   "occupancy": None if occupancy is None
                   else round(occupancy, 3)}
            if "failures" in summary:
                out["failures"] = summary["failures"]
            if "admission" in summary:
                out["admission"] = dict(summary["admission"],
                                        rejected_submits=rejected)
            if "trace" in summary:
                out["stages"] = summary["trace"]["stages"]
            print(json.dumps(out))
        if args.ingest is not None and args.ingest >= 1:
            # streaming ingestion: tail-shard append + epoch advance while
            # the service stays up, then the same stream at the new epoch
            rng2 = np.random.default_rng(1)
            new_emb = gen(rng2, args.ingest, args.dim)
            new_docs = synth.passages(rng2, args.ingest, avg_bytes=256)
            t0 = time.monotonic()
            view = index.ingest(new_emb, documents=new_docs)
            spans = (engine.replan() if args.replicas > 1
                     else (engine.refresh_corpus() and None))
            ingest_ms = (time.monotonic() - t0) * 1e3
            print(json.dumps({"ingest": {
                "docs": args.ingest, "epoch": view.epoch,
                "num_rows": index.num_rows,
                "ingest_ms": round(ingest_ms, 1),
                "replanned_slices": spans}}))
            grown = index.embeddings.cpu().numpy()
            for t in range(args.tenants):   # re-plan sessions for the
                engine.open_session(        # grown corpus + new epoch
                    f"tenant-{t}@e{view.epoch}", n=args.dim,
                    N=index.num_rows, k=args.k, radius=args.radius,
                    backend=args.backend)
            rid_to_query = {}
            for i, q in enumerate(queries):
                rid = engine.submit(
                    f"tenant-{i % args.tenants}@e{view.epoch}", q,
                    key=10_000 + i)
                rid_to_query[rid] = q
            for res in engine.drain():
                if not res.ok:
                    print(json.dumps({
                        "request": res.request_id, "tenant": res.tenant,
                        "epoch": view.epoch, "error": res.error}))
                    continue
                q = rid_to_query[res.request_id]
                plain = np.argsort(-(grown @ q), kind="stable")[: args.k]
                recall = (len(set(res.ids.tolist()) & set(plain.tolist()))
                          / args.k)
                print(json.dumps({
                    "request": res.request_id, "tenant": res.tenant,
                    "epoch": view.epoch,
                    "latency_s": round(res.latency_s, 3),
                    "recall": recall,
                    "wire_bytes": res.transcript.total_bytes}))
        if args.trace_out is not None:
            n_events = engine.write_trace(args.trace_out)
            print(json.dumps({"trace_out": args.trace_out,
                              "trace_events": n_events,
                              "view": "https://ui.perfetto.dev"}))


if __name__ == "__main__":
    main()
