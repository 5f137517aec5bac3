"""The port's `ServeEngine` against the JAX package's, and its own
batched-vs-sequential, fault-isolation, trigger and launcher contracts.

`jax.random` cannot be replayed in torch, so the reference-parity tests
patch the port's `serve.batching.perturb_batch` (inside the test only) to
return the perturbed embeddings the JAX engine's `perturb_batch` gives for
the same request keys: a port request's generator seed is the JAX request's
`PRNGKey` seed.  Tenant keys and encryption noise come from the same numpy
streams (`tenant_seed`), so ids, documents and wire bytes must match per
request, on the dense and on the sharded cache."""

import dataclasses
import io
import json
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from repro.crypto import rlwe as jr
from repro.data import synth
from repro.retrieval.index import FlatIndex as JFlatIndex
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import batching as jbatching
from repro.serve.session import SessionManager as JSessionManager
from repro_torch import convert
from repro_torch.crypto import rlwe as tr
from repro_torch.crypto.backend import UnknownBackend
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import EngineConfig, ServeEngine, admission
from repro_torch.serve import batching
from repro_torch.serve.session import PlanCache, SessionManager

N_DOCS, DIM, K = 500, 64, 4
N_REQ = 8
TENANTS = ("alice", "bob", "carol")
JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)
SHARD_DOCS = 64


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    docs = [f"passage-{i}".encode() for i in range(N_DOCS)]
    jidx = JFlatIndex.build(emb, documents=docs)
    queries = synth.queries_near_corpus(rng, emb, N_REQ)
    return jidx, docs, queries


def _index(corpus):
    jidx, docs, _ = corpus
    return convert.flat_index(np.asarray(jidx.embeddings), docs, device="cpu")


def _build(index, *, sequential=False, max_batch=8, clock=None, **kw):
    extra = {"clock": clock} if clock is not None else {}
    eng = ServeEngine(
        index, config=EngineConfig(max_batch=max_batch, max_wait_s=30.0,
                                   sequential=sequential, **kw),
        sessions=SessionManager(rlwe_params=TP, deterministic_seeds=True,
                                device="cpu"), **extra)
    for t in TENANTS:
        eng.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    return eng


def _run(index, queries, **kw):
    eng = _build(index, **kw)
    for i, q in enumerate(queries):
        eng.submit(TENANTS[i % len(TENANTS)], q, key=i)
    return eng, eng.drain()


def _same(a, b):
    assert a.request_id == b.request_id and a.tenant == b.tenant
    assert np.asarray(a.ids).tolist() == np.asarray(b.ids).tolist()
    assert a.docs == b.docs
    for f in ("total_bytes", "request_bytes", "reply_bytes"):
        assert getattr(a.transcript, f) == getattr(b.transcript, f)


def _jax_perturb(generators, E, epss, *, device=None):
    """The reference engine's perturbation of the same requests: the
    port's generator seed is the reference's PRNGKey seed."""
    keys = [jax.random.PRNGKey(g.initial_seed()) for g in generators]
    return torch.from_numpy(np.array(jbatching.perturb_batch(keys, E, epss)))


@pytest.mark.parametrize("cached", ["dense", "sharded"])
def test_engine_matches_reference(corpus, monkeypatch, cached):
    jidx, _, queries = corpus
    jcfg = tcfg = None
    if cached == "sharded":
        jcfg = jr.CandidateCacheConfig(shard_docs=SHARD_DOCS,
                                       max_resident_bytes=0)
        tcfg = tr.CandidateCacheConfig(shard_docs=SHARD_DOCS,
                                       max_resident_bytes=0)
    jeng = JServeEngine(
        jidx, config=JEngineConfig(max_batch=8, max_wait_s=30.0,
                                   cache_config=jcfg),
        sessions=JSessionManager(rlwe_params=JP, deterministic_seeds=True))
    for t in TENANTS:
        jeng.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    for i, q in enumerate(queries):
        jeng.submit(TENANTS[i % len(TENANTS)], q, key=jax.random.PRNGKey(i))
    want = jeng.drain()
    jeng.close()

    monkeypatch.setattr(batching, "perturb_batch", _jax_perturb)
    eng, got = _run(_index(corpus), queries, cache_config=tcfg)
    assert len(got) == len(want) == N_REQ
    assert all(r.ok for r in got) and [r.batch_size for r in got] == [8] * 8
    for a, b in zip(want, got):
        _same(a, b)
    if cached == "sharded":
        st, jst = eng.cache_stats(), jeng.cache_stats()
        for key in ("hits", "misses", "gathered_bytes", "prefetches",
                    "admissions", "resident_shards"):
            assert st[key] == jst[key], key
        assert st["prefetches"] > 0 and st["admissions"] == 0
    else:
        assert eng.cache_stats() is None
    eng.close()


@pytest.mark.parametrize("max_batch", [1, 3, 8])
def test_batched_matches_sequential(corpus, max_batch):
    """Same docs / ids / wire bytes at batch sizes 1, 3, 8 as the
    sequential run_remoterag path, and the plaintext top-k."""
    jidx, _, queries = corpus
    index = _index(corpus)
    _, seq = _run(index, queries, sequential=True, max_batch=1)
    assert [r.batch_size for r in seq] == [1] * N_REQ
    _, got = _run(index, queries, max_batch=max_batch)
    assert max(r.batch_size for r in got) == min(max_batch, N_REQ)
    emb = np.asarray(jidx.embeddings)
    for rs, rb in zip(seq, got):
        _same(rs, rb)
        oracle = np.argsort(-(emb @ queries[rb.request_id]), kind="stable")
        assert set(rb.ids.tolist()) == set(oracle[:K].tolist())


class _PoisonIds:
    """Persistently poison ONE lane: its fetch (batched and solo retry)
    raises; every other lane's fetch delegates."""

    def __init__(self, cloud, poison_ids):
        self.cloud = cloud
        self.poison_ids = list(poison_ids)

    def __call__(self, cand_ids, msg):
        if [int(cand_ids[p]) for p in msg.positions] == self.poison_ids:
            raise RuntimeError("persistently poisoned lane")
        return type(self.cloud).handle_fetch(self.cloud, cand_ids, msg)


@pytest.mark.parametrize("retry_lane", [True, False])
def test_poisoned_lane_isolated_and_retried(corpus, retry_lane):
    """One poisoned lane in a batch of 8: only it errors (after its solo
    retry, on the background retry lane or inline), the other 7 match the
    sequential path, no healthy lane is encrypted twice, and exactly one
    batch is recorded."""
    index = _index(corpus)
    queries = corpus[2]
    _, want = _run(index, queries, sequential=True, max_batch=1)
    assert len({tuple(r.ids.tolist()) for r in want}) == N_REQ
    eng = _build(index, retry_lane=retry_lane)
    eng.cloud.handle_fetch = _PoisonIds(eng.cloud, want[0].ids.tolist())
    for i, q in enumerate(queries):
        eng.submit(TENANTS[i % len(TENANTS)], q, key=i)
    got = eng.drain()
    assert [r.request_id for r in got] == list(range(N_REQ))
    bad = [r for r in got if not r.ok]
    assert [r.request_id for r in bad] == [0]
    assert "persistently poisoned lane" in bad[0].error and bad[0].quarantined
    for rs, rb in zip(want[1:], got[1:]):
        assert rb.ok and not rb.quarantined
        _same(rs, rb)
    m = eng.metrics
    assert m.num_batches == 1 and list(m.dispatch_sizes) == [N_REQ]
    assert m.quarantined_lanes == 1 and m.retried_requests == 1
    assert m.error_results == 1 and m.quarantined_retry_ok == 0
    assert m.lane_encryptions == N_REQ + 1 and m.healthy_reencryptions == 0
    assert m.occupancy(N_REQ) == (N_REQ - 1) / N_REQ
    pool = eng._retry_pool
    eng.close()
    assert eng._retry_pool is None
    if pool is not None:                      # the retry lane was joined
        assert all(not t.is_alive() for t in pool._threads)


def test_batched_stage_fault_is_bisected(corpus, monkeypatch):
    """A fault in the batched perturbation pins by bisection to its lane;
    the lane heals on the solo sequential retry."""
    index = _index(corpus)
    queries = corpus[2]
    poison = np.asarray(queries[2], np.float32)
    real = batching.perturb_batch

    def poisoned(gens, E, epss, **kw):
        if any(np.array_equal(row, poison) for row in np.asarray(E)):
            raise RuntimeError("poisoned batched stage")
        return real(gens, E, epss, **kw)

    _, want = _run(index, queries, sequential=True, max_batch=1)
    monkeypatch.setattr(batching, "perturb_batch", poisoned)
    eng, got = _run(index, queries)
    assert all(r.ok for r in got)
    assert [r.request_id for r in got if r.quarantined] == [2]
    for rs, rb in zip(want, got):
        _same(rs, rb)
    assert eng.metrics.quarantined_retry_ok == 1


def test_size_and_deadline_triggers(corpus):
    queries = corpus[2]
    now = [0.0]
    eng = _build(_index(corpus), max_batch=3, clock=lambda: now[0])
    eng.config = EngineConfig(max_batch=3, max_wait_s=5.0)
    eng.submit("alice", queries[0], key=0)
    eng.submit("bob", queries[1], key=1)
    assert eng.step() == [] and eng.pending == 2   # no trigger fired
    eng.submit("carol", queries[2], key=2)
    out = eng.step()                               # size trigger
    assert len(out) == 3 and eng.pending == 0
    eng.submit("alice", queries[3], key=3)
    assert eng.step() == []
    now[0] += 6.0                                  # age past the deadline
    out = eng.step()
    assert len(out) == 1 and out[0].batch_size == 1


def test_plan_cache_and_sessions():
    cache = PlanCache()
    mgr = SessionManager(rlwe_params=TP, plan_cache=cache, device="cpu")
    a = mgr.open("a", n=DIM, N=N_DOCS, k=K, radius=0.05)
    assert (cache.hits, cache.misses) == (0, 1)
    b = mgr.open("b", n=DIM, N=N_DOCS, k=K, radius=0.05)
    assert (cache.hits, cache.misses) == (1, 1)
    assert a.plan is b.plan and a.user.sk is not b.user.sk
    mgr.open("c", n=DIM, N=N_DOCS, k=K, radius=0.09)
    assert cache.misses == 2
    assert mgr.open("a", n=DIM, N=N_DOCS, k=K, radius=0.05) is a
    with pytest.raises(ValueError, match="different knobs"):
        mgr.open("a", n=DIM, N=N_DOCS, k=K, radius=0.09)
    # deterministic sessions hold the reference's keys, bit for bit
    det = SessionManager(rlwe_params=TP, deterministic_seeds=True,
                         device="cpu").open("alice", n=DIM, N=N_DOCS, k=K,
                                            radius=0.05)
    jdet = JSessionManager(rlwe_params=JP, deterministic_seeds=True).open(
        "alice", n=DIM, N=N_DOCS, k=K, radius=0.05)
    np.testing.assert_array_equal(det.user.sk.s_ntt.numpy(),
                                  np.asarray(jdet.user.sk.s_ntt))
    assert dataclasses.asdict(det.plan) == dataclasses.asdict(jdet.plan)


def test_submit_errors_and_deadline_shedding(corpus):
    queries = corpus[2]
    eng = _build(_index(corpus), max_batch=2)
    with pytest.raises(KeyError, match="nobody"):
        eng.submit("nobody", queries[0])
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(TENANTS[0], queries[0][None, :])
    with pytest.raises(ValueError, match="sessions on"):
        ServeEngine(_index(corpus), sessions=SimpleNamespace(
            device=torch.device("meta"), rlwe_params=TP))
    now = [0.0]
    shed_eng = _build(_index(corpus), max_batch=8, clock=lambda: now[0],
                      admission=admission.AdmissionConfig(
                          default_deadline_s=1.0))
    rid = shed_eng.submit("alice", queries[0], key=0)
    now[0] += 2.0                                  # budget spent in queue
    out = shed_eng.drain()
    assert [(r.request_id, r.shed_reason) for r in out] == [
        (rid, admission.SHED_DEADLINE)]
    assert shed_eng.metrics.lane_encryptions == 0  # shed before any crypto
    eng.close()
    shed_eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit("alice", queries[0])


def test_sharded_engine_traces_and_closes(corpus):
    """Sharded cache with the default async admitter under tracing: the
    same results as the dense engine, cache spans in the trace, and no
    admitter or retry thread left after close."""
    index = _index(corpus)
    queries = corpus[2]
    _, dense = _run(index, queries)
    cfg = tr.CandidateCacheConfig(shard_docs=SHARD_DOCS, admit_threshold=1,
                                  max_resident_bytes=None)
    eng, got = _run(_index(corpus), queries, cache_config=cfg, trace=True)
    for a, b in zip(dense, got):
        _same(a, b)
    names = {s.name for s in eng.tracer.spans()}
    assert {"queue_wait", "dispatch", "perturb", "topk", "encrypt", "score",
            "decrypt", "finish", "cache_prefetch", "cache_gather"} <= names
    summary = eng.trace_summary()
    assert summary is not None and "stages" in summary
    worker = eng.cloud.candidate_cache._worker
    eng.close()
    st = eng.cache_stats()
    assert st["admit_enqueued"] > 0 and st["pending_admissions"] == 0
    assert eng.cloud.candidate_cache._worker is None     # admitter joined
    assert worker is None or not worker.is_alive()


def test_launch_serve_main_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--n-docs", "300", "--dim",
                           "64", "--requests", "4", "--tenants", "2",
                           "--max-batch", "2"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert lines[0] == {"device": {"type": "cpu", "name": "cpu"}}
    served = [x for x in lines if "recall" in x]
    assert len(served) == 4 and all(x["recall"] == 1.0 for x in served)
    assert lines[-1]["num_batches"] == 2
    # the router, IVF routing and ingestion flags, as the reference's
    base = ["--device", "cpu", "--n-docs", "300", "--dim", "64",
            "--requests", "4", "--tenants", "2", "--max-batch", "2"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(base + ["--replicas", "2", "--corpus", "clustered",
                                  "--ivf-clusters", "3", "--nprobe", "auto",
                                  "--ingest", "10"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    assert lines[1]["ivf"]["clusters"] == 3
    fleet = next(x for x in lines if "router" in x)
    assert fleet["router"]["num_replicas"] == 2
    assert sum(fleet["router"]["completed"]) == 4
    ingest = next(x["ingest"] for x in lines if "ingest" in x)
    assert (ingest["epoch"], ingest["num_rows"]) == (1, 310)
    assert ingest["replanned_slices"][-1][1] == 310
    grown = [x for x in lines if x.get("epoch") == 1]
    assert len(grown) == 4 and all("error" not in x for x in grown)
    with pytest.raises(SystemExit):
        launch_serve.main(base + ["--nprobe", "2"])    # needs --ivf-clusters
    with pytest.raises(UnknownBackend):
        launch_serve.main(["--device", "cpu", "--backend", "paillier"])
