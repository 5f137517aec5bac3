"""The port's `ReplicaRouter` (CPU, plain PyTorch path): bit identity with
one engine over the whole corpus and with the JAX package's engine, the
scatter-gather merge's determinism, replica fault injection with zero
lost requests, and typed admission errors through the router.

Mirrors the reference's ``tests/test_router.py`` (RLWE, and the Paillier
bit-identity case), at its sizes (1500 docs x 64, three planted copies of row 100 across every
replica boundary).  Several of those reference cases are red on the CPU,
where XLA's float32 dot gives a row a score that depends on the matrix it
sits in; here a score depends on its (query, row) pair alone, so the
per-slice scans merged by (score desc, id asc) equal the flat scan bit for
bit and the router equals the single engine at every replica count.
"""

import threading
import time

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
from repro.serve.router import merge_topk as j_merge_topk
from repro.serve.session import SessionManager as JSessionManager
from repro_torch import convert
from repro_torch.crypto import rlwe as tr
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.retrieval.index import FlatIndex, plan_row_slices
from repro_torch.retrieval.topk import slice_topk
from repro_torch.serve import (AdmissionConfig, EngineConfig, RateLimited,
                               ReplicaRouter, ReplicaUnavailable,
                               RouterConfig, ServeEngine, SessionManager,
                               batching, merge_topk)

N_DOCS, DIM, K = 1500, 64, 4
N_REQ = 8
TENANTS = ("alice", "bob", "carol", "dave")
JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)
SEED = 0


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(SEED)
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    emb[800] = emb[100]       # duplicates straddle the 750 boundary (N=2)
    emb[1200] = emb[100]      # ... and the 1125 boundary (N=4)
    emb[400] = emb[100]       # ... and the 375 boundary (N=4)
    docs = [f"passage-{i}".encode() for i in range(N_DOCS)]
    index = FlatIndex.build(emb, documents=docs, normalize=False,
                            device="cpu")
    queries = synth.queries_near_corpus(rng, emb, N_REQ)
    queries[3] = emb[100]     # its ties surface in the top-k'
    return index, emb, queries


@pytest.fixture
def one_thread():
    """One intra-op thread for the Paillier path's many small CPU ops:
    beside other busy test workers a thread-parallel region costs
    milliseconds an op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sessions():
    return SessionManager(rlwe_params=TP, deterministic_seeds=True,
                          device="cpu")


def _open_all(srv, *, kprime=None, backend="rlwe"):
    plan_kw = ({"plan_kwargs": {"kprime": kprime}} if kprime
               else {"radius": 0.05})
    if backend == "paillier":
        plan_kw["paillier_bits"] = 256
    for t in TENANTS:
        srv.open_session(t, n=DIM, N=N_DOCS, k=K, backend=backend, **plan_kw)


def _submit_all(srv, queries):
    return [srv.submit(TENANTS[i % len(TENANTS)], q, key=i)
            for i, q in enumerate(queries)]


def _by_rid(results):
    return {r.request_id: r for r in results}


_SINGLE = {}    # (max_batch, backend, requests) -> the single engine's results


def _single_run(index, queries, *, max_batch=8, backend="rlwe"):
    key = (max_batch, backend, len(queries))
    if key not in _SINGLE:
        eng = ServeEngine(index, config=EngineConfig(max_batch=max_batch,
                                                     max_wait_s=30.0),
                          sessions=_sessions())
        _open_all(eng, backend=backend)
        _submit_all(eng, queries)
        _SINGLE[key] = eng.drain()
        eng.close()
    return _SINGLE[key]


def _router(index, *, num_replicas, max_batch=8, engine_kw=None,
            router_kw=None):
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=num_replicas,
        engine=EngineConfig(max_batch=max_batch, max_wait_s=30.0,
                            **(engine_kw or {})),
        **(router_kw or {})), sessions=_sessions())
    _open_all(rt)
    return rt


def _assert_results_identical(want, got):
    assert sorted(r.request_id for r in got) == \
        sorted(r.request_id for r in want)
    wd = _by_rid(want)
    for rb in got:
        rs = wd[rb.request_id]
        assert rs.tenant == rb.tenant
        assert np.asarray(rs.ids).tolist() == rb.ids.tolist()
        assert rs.docs == rb.docs
        for f in ("total_bytes", "request_bytes", "reply_bytes"):
            assert getattr(rs.transcript, f) == getattr(rb.transcript, f)
        assert rs.error == rb.error


# -- bit identity ------------------------------------------------------------


@pytest.mark.parametrize("num_replicas,max_batch",
                         [(1, 8), (2, 1), (2, 3), (2, 8), (4, 3), (4, 8)])
def test_router_bit_identical_to_single_engine(corpus, num_replicas,
                                               max_batch):
    index, _, queries = corpus
    want = _single_run(index, queries, max_batch=max_batch)
    rt = _router(index, num_replicas=num_replicas, max_batch=max_batch)
    rids = _submit_all(rt, queries)
    got = rt.drain()
    rt.close()
    assert rids == [r.request_id for r in want]   # ids are submit order
    assert len(got) == N_REQ and all(r.ok for r in got)
    _assert_results_identical(want, got)
    # the query aimed at row 100 gets it and its three copies, tied, in
    # id order
    assert got[3].ids.tolist() == [100, 400, 800, 1200]
    m = rt.metrics.summary()
    assert sum(m["submitted"]) == N_REQ and sum(m["completed"]) == N_REQ
    assert m["quarantines"] == [] and m["late_dropped"] == 0
    assert m["scatter_calls"] > 0 and m["fallback_scans"] == 0
    assert m["slice_scans"] == m["scatter_calls"] * num_replicas


@pytest.mark.usefixtures("one_thread")
def test_router_bit_identical_paillier_backend(corpus):
    """The Paillier backend through the router: per request equal to one
    engine, with the replicas' batches scored on their own threads."""
    index, _, queries = corpus
    want = _single_run(index, queries[:4], max_batch=4, backend="paillier")
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=2, engine=EngineConfig(max_batch=4, max_wait_s=30.0)),
        sessions=_sessions())
    _open_all(rt, backend="paillier")
    _submit_all(rt, queries[:4])
    got = rt.drain()
    rt.close()
    assert len(got) == 4 and all(r.ok for r in got)
    _assert_results_identical(want, got)
    assert got[3].ids.tolist() == [100, 400, 800, 1200]


def _jax_perturb(generators, E, epss, *, device=None):
    """The reference engine's perturbation of the same requests: the
    port's generator seed is the reference's PRNGKey seed."""
    keys = [jax.random.PRNGKey(g.initial_seed()) for g in generators]
    return torch.from_numpy(np.array(jbatching.perturb_batch(keys, E, epss)))


def test_router_matches_reference_engine(corpus, monkeypatch):
    """Per request, a 4-replica router equals the reference's single engine
    (ids, documents, wire bytes), with the reference's perturbations.  The
    four bitwise-identical copies of row 100 are one document to this
    comparison: on the CPU the reference scores them a ulp apart (its dot
    depends on where a row sits in the matrix) and returns them in that
    order, the port ties them exactly and returns them in id order."""
    index, emb, queries = corpus
    jidx = JFlatIndex.build(emb, documents=index.documents, normalize=False)
    jeng = JServeEngine(
        jidx, config=JEngineConfig(max_batch=8, max_wait_s=30.0),
        sessions=JSessionManager(rlwe_params=JP, deterministic_seeds=True))
    for t in TENANTS:
        jeng.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    for i, q in enumerate(queries):
        jeng.submit(TENANTS[i % len(TENANTS)], q, key=jax.random.PRNGKey(i))
    want = jeng.drain()
    jeng.close()
    monkeypatch.setattr(batching, "perturb_batch", _jax_perturb)
    rt = _router(convert.flat_index(np.asarray(jidx.embeddings),
                                    jidx.documents, device="cpu"),
                 num_replicas=4)
    _submit_all(rt, queries)
    got = rt.drain()
    rt.close()
    assert all(r.ok for r in got)
    same_row = {i: 100 for i in (100, 400, 800, 1200)}
    for rs, rb in zip(want, got):
        assert (rs.request_id, rs.tenant) == (rb.request_id, rb.tenant)
        assert [same_row.get(int(i), int(i)) for i in rs.ids] == \
            [same_row.get(int(i), int(i)) for i in rb.ids]
        assert rb.docs == [f"passage-{int(i)}".encode() for i in rb.ids]
        assert sorted(rs.docs) == sorted(rb.docs)
        for f in ("total_bytes", "request_bytes", "reply_bytes"):
            assert getattr(rs.transcript, f) == getattr(rb.transcript, f)
    assert sorted(int(i) for i in want[3].ids) == \
        [int(i) for i in got[3].ids] == [100, 400, 800, 1200]


def test_kprime_straddles_replica_boundaries(corpus):
    """k' = 751 > one replica's 750 docs: candidates come from both slices
    and merge to the full scan's list, ids and value bits."""
    index, _, queries = corpus
    slices = plan_row_slices(N_DOCS, 2)
    assert slices == [(0, 750), (750, 1500)]
    q = torch.from_numpy(queries)
    full = sops.topk_scores(q, index.embeddings, 751)
    parts = [slice_topk(index.slice_view(s, e), q, 751) for s, e in slices]
    merged = merge_topk([p.values.numpy() for p in parts],
                        [p.indices.numpy() for p in parts], 751)
    assert merged.tolist() == full.indices.numpy().tolist()
    vals = np.concatenate([p.values.numpy() for p in parts], axis=1)
    ids = np.concatenate([p.indices.numpy() for p in parts], axis=1)
    by_id = np.take_along_axis(vals, np.argsort(ids, axis=1, kind="stable"),
                               axis=1)
    assert np.array_equal(np.take_along_axis(by_id, merged, axis=1).view(
        np.uint32), full.values.numpy().view(np.uint32))


def test_kprime_larger_than_one_replica_slice():
    """A 40-doc corpus over 4 replicas (10 docs each) with k' = 25: every
    replica contributes its whole slice, results still bit-identical."""
    rng = np.random.default_rng(SEED + 1)
    emb = synth.uniform_corpus(rng, 40, DIM)
    index = FlatIndex.build(emb, documents=[f"d{i}".encode()
                                            for i in range(40)],
                            normalize=False, device="cpu")
    queries = synth.queries_near_corpus(rng, emb, 4)

    def run(srv):
        for t in TENANTS:
            srv.open_session(t, n=DIM, N=40, k=K,
                             plan_kwargs={"kprime": 25})
        _submit_all(srv, queries)
        out = srv.drain()
        srv.close()
        return out

    want = run(ServeEngine(index, config=EngineConfig(max_batch=4,
                                                      max_wait_s=30.0),
                           sessions=_sessions()))
    got = run(ReplicaRouter(index, config=RouterConfig(
        num_replicas=4, engine=EngineConfig(max_batch=4, max_wait_s=30.0)),
        sessions=_sessions()))
    assert all(r.ok for r in got)
    _assert_results_identical(want, got)


# -- merge-order determinism --------------------------------------------------


@pytest.mark.parametrize("trial", range(8))
def test_merge_topk_fuzz_matches_full_scan(trial):
    """Random corpora with planted duplicate rows, random cuts: per-slice
    top-k + merge == the full scan, ids and value bits; the port's merge
    equals the reference's on the same candidates."""
    rng = np.random.default_rng(SEED + trial)
    n = int(rng.integers(50, 400))
    emb = rng.normal(size=(n, 16)).astype(np.float32)
    for _ in range(int(rng.integers(1, 6))):
        i, j = rng.integers(0, n, size=2)
        emb[j] = emb[i]
    q = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    k = int(rng.integers(1, n + 1))
    cuts = plan_row_slices(n, int(rng.integers(1, min(6, n) + 1)))
    index = FlatIndex.build(emb, normalize=False, device="cpu")
    parts = [slice_topk(index.slice_view(s, e), q, k, tile=64)
             for s, e in cuts]
    pv = [p.values.numpy() for p in parts]
    pi = [p.indices.numpy() for p in parts]
    merged = merge_topk(pv, pi, k)
    full = sops.topk_scores(q, index.embeddings, k, tile=64)
    assert merged.tolist() == full.indices.numpy().tolist(), (n, k, cuts)
    assert np.array_equal(merged, j_merge_topk(pv, pi, k))
    got_v = np.concatenate(pv, 1)[np.arange(3)[:, None],
                                  [[list(np.concatenate(pi, 1)[b]).index(g)
                                    for g in merged[b]] for b in range(3)]]
    assert np.array_equal(got_v.view(np.uint32),
                          full.values.numpy().view(np.uint32))


def test_merge_is_arrival_order_independent(corpus):
    """Seeded random stalls in the scan hook reorder the scans' completion;
    the merged block never changes."""
    index, _, queries = corpus
    rt = _router(index, num_replicas=4)
    try:
        pert = torch.from_numpy(np.asarray(queries[:5], np.float32))
        want = rt._scatter_topk(pert, 32, home=0)
        for trial in range(5):
            delays = np.random.default_rng(SEED + trial).uniform(
                0.0, 0.02, size=4)
            rt._scan_hook = lambda r, d=delays: time.sleep(d[r])
            got = rt._scatter_topk(pert, 32, home=trial % 4)
            assert np.array_equal(want, got), f"trial={trial}"
    finally:
        rt._scan_hook = None
        rt.close()
    assert rt.metrics.summary()["quarantines"] == []


# -- replica fault injection ------------------------------------------------


class _PoisonOnce:
    """Fail exactly one fetch (the one resolving to ``poison_ids``), so that
    lane is quarantined in the batch and heals on its solo retry."""

    def __init__(self, cloud, poison_ids):
        self.cloud = cloud
        self.poison_ids = list(poison_ids)
        self.fired = False

    def __call__(self, cand_ids, msg):
        ids = [int(cand_ids[p]) for p in msg.positions]
        if ids == self.poison_ids and not self.fired:
            self.fired = True
            raise RuntimeError("transient poisoned lane")
        return type(self.cloud).handle_fetch(self.cloud, cand_ids, msg)


def test_engine_quarantine_retry_stays_slice_routed(corpus, monkeypatch):
    """A lane quarantined inside a replica's engine retries solo through
    the router's scatter-gather searcher, never a whole-index scan (the
    protocol's flat top-k' is poisoned), and stays bit-identical."""
    from repro_torch.core import protocol as protocol_mod

    index, _, queries = corpus
    want = _by_rid(_single_run(index, queries))

    def no_full_scan(*a, **kw):
        raise AssertionError("solo retry bypassed the per-slice scatter")

    monkeypatch.setattr(protocol_mod, "distributed_topk", no_full_scan)
    rt = _router(index, num_replicas=2)
    victim = rt.home_replica(TENANTS[0])
    eng = rt.replicas[victim].engine
    eng.cloud.handle_fetch = _PoisonOnce(eng.cloud, want[0].ids.tolist())
    rids = _submit_all(rt, queries)
    got = _by_rid(rt.drain())
    rt.close()
    assert set(got) == set(rids)
    assert all(r.ok for r in got.values())
    assert [rid for rid, r in got.items() if r.quarantined] == [0]
    for rid in rids:
        assert got[rid].ids.tolist() == want[rid].ids.tolist()
        assert got[rid].docs == want[rid].docs
        assert (got[rid].transcript.total_bytes
                == want[rid].transcript.total_bytes)
    m = rt.metrics.summary()
    assert m["quarantines"] == [] and m["fallback_scans"] == 0


def test_scan_fault_quarantines_and_falls_back(corpus):
    """One replica's scan worker raises: it is quarantined, its slice is
    scanned by the caller-thread fallback, healthy replicas' results stay
    bit-identical, the victim's requests resolve as typed errors."""
    index, _, queries = corpus
    want = _by_rid(_single_run(index, queries))
    rt = _router(index, num_replicas=2)
    victim = 1

    def hook(replica_id):
        if replica_id == victim:
            raise RuntimeError("injected scan fault")

    rids = _submit_all(rt, queries)
    victim_rids = {rid for rid, t in zip(rids, TENANTS * 2)
                   if rt.home_replica(t) == victim}
    healthy_rids = set(rids) - victim_rids
    assert victim_rids and healthy_rids
    rt._scan_hook = hook
    got = _by_rid(rt.drain())
    rt.close()
    assert set(got) == set(rids)
    for rid in healthy_rids:
        rs, rb = want[rid], got[rid]
        assert rb.ok and rs.ids.tolist() == rb.ids.tolist()
        assert rs.docs == rb.docs
        assert rs.transcript.total_bytes == rb.transcript.total_bytes
    for rid in victim_rids:
        rb = got[rid]
        assert not rb.ok and rb.quarantined
        assert "replica_quarantined" in rb.error
        assert rb.docs == [] and rb.ids.size == 0
    m = rt.metrics.summary()
    assert [q[0] for q in m["quarantines"]] == [victim]
    assert m["quarantines"][0][1].startswith("scan:")
    assert m["quarantine_resolved"] == len(victim_rids)
    assert m["fallback_scans"] >= 1


def test_step_fault_resolves_inflight_as_typed_errors(corpus):
    index, _, queries = corpus
    rt = _router(index, num_replicas=2)
    victim = 0
    rids = _submit_all(rt, queries)
    victim_rids = {rid for rid, t in zip(rids, TENANTS * 2)
                   if rt.home_replica(t) == victim}

    def boom(*a, **kw):
        raise RuntimeError("injected step fault")

    rt.replicas[victim].engine.step = boom
    rt.replicas[victim].engine.drain = boom
    got = _by_rid(rt.drain())
    assert set(got) == set(rids)
    for rid in rids:
        if rid in victim_rids:
            assert not got[rid].ok and got[rid].quarantined
            assert "replica_quarantined(drain:RuntimeError)" in \
                got[rid].error
        else:
            assert got[rid].ok
    m = rt.metrics.summary()
    assert m["quarantines"] == [[victim, "drain:RuntimeError"]]
    assert m["quarantine_resolved"] == len(victim_rids)
    probe = next(t for t in TENANTS if rt.home_replica(t) == victim)
    rid = rt.submit(probe, queries[0], key=99)
    out = _by_rid(rt.drain())
    assert out[rid].ok                    # rehomed to the healthy replica
    assert rt.metrics.summary()["rehomed"] >= 1
    rt.close()


def test_stalled_replica_times_out_and_quarantines(corpus):
    """A replica that never returns is quarantined after step_timeout_s
    with its in-flight requests resolved; the router never hangs."""
    index, _, queries = corpus
    rt = _router(index, num_replicas=2, router_kw={"step_timeout_s": 1.0})
    victim_tenant = TENANTS[0]
    victim = rt.home_replica(victim_tenant)
    rids = [rt.submit(victim_tenant, queries[i], key=i) for i in range(3)]
    stall = threading.Event()

    def hang(*a, **kw):
        stall.wait(timeout=20.0)
        return []

    rt.replicas[victim].engine.drain = hang
    t0 = time.monotonic()
    got = _by_rid(rt.drain())
    assert time.monotonic() - t0 < 10.0
    stall.set()
    assert set(got) == set(rids)
    for rid in rids:
        assert not got[rid].ok
        assert "replica_quarantined(drain_stalled)" in got[rid].error
    assert rt.metrics.summary()["quarantines"] == [[victim, "drain_stalled"]]
    rt.close()


def test_all_replicas_down_is_typed(corpus):
    index, _, queries = corpus
    rt = _router(index, num_replicas=2)
    for r in range(2):
        rt._quarantine(r, "test")
    with pytest.raises(ReplicaUnavailable):
        rt.submit(TENANTS[0], queries[0])
    rt.close()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(TENANTS[0], queries[0])


# -- typed admission errors through the router ------------------------------


def test_rate_limit_propagates_and_consumes_no_request_id(corpus):
    index, _, queries = corpus
    rt = _router(index, num_replicas=2,
                 engine_kw={"admission": AdmissionConfig(
                     tenant_rate=0.001, tenant_burst=2.0)})
    t = TENANTS[0]
    other = next(x for x in TENANTS
                 if rt.home_replica(x) != rt.home_replica(t))
    r0 = rt.submit(t, queries[0], key=0)
    r1 = rt.submit(t, queries[1], key=1)
    with pytest.raises(RateLimited) as exc:
        rt.submit(t, queries[2], key=2)
    assert exc.value.retry_after_s > 0
    r2 = rt.submit(other, queries[3], key=3)
    assert [r0, r1, r2] == [0, 1, 2]
    m = rt.metrics.summary()
    assert sum(m["rejected"]) == 1 and sum(m["submitted"]) == 3
    out = rt.drain()
    assert sorted(r.request_id for r in out) == [0, 1, 2]
    assert all(r.ok for r in out)
    rt.close()


def test_unknown_tenant_and_bad_embedding_are_typed(corpus):
    index, _, queries = corpus
    rt = _router(index, num_replicas=2)
    with pytest.raises(KeyError, match="nobody"):
        rt.submit("nobody", queries[0])
    with pytest.raises(ValueError, match="1-D"):
        rt.submit(TENANTS[0], queries[0][None, :])
    rid = rt.submit(TENANTS[0], queries[0], key=0)
    assert rid == 0                       # neither consumed an id
    rt.drain()
    summary = rt.summary()
    assert summary["slices"] == [[0, 750], [750, 1500]]
    assert summary["epoch"] == 0
    rt.close()
