"""The port's epoch-versioned corpus and IVF first stage against the JAX
package's, and its own contracts (CPU, plain PyTorch path).

Against the reference: the k-means permutation and `ClusterMap`, bit for
bit; `plan_nprobe`; routed `cluster_topk` ids (up to scores tied within
1e-5: the two packages sum float32 products in different orders); the
ingested tail shard's rows, bit for bit; and, per request, a router over
the IVF corpus against the reference's flat engine with the reference's
perturbations patched in.

The port's own contracts, at the reference's 600 docs x 64 with planted
duplicate rows: ``nprobe`` in {None, C, C + 3} equals the flat scan bit
for bit, values and ids (the reference's own test of this is red on the
CPU, where XLA's float32 dot depends on the matrix a row sits in); a
pinned epoch replays bit for bit under a concurrent ingest; a mid-ingest
gather never sees a half-published tail shard; and a router over the IVF
corpus (replicas {1, 2, 4} x batch {1, 3, 8}, a tail ingested before the
requests) equals a flat engine before the ingest.
"""

import threading

import numpy as np
import pytest
import torch

import jax

from repro.crypto import rlwe as jr
from repro.data import synth
from repro.retrieval import index as jindex
from repro.retrieval import topk as jtopk
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import batching as jbatching
from repro.serve.session import SessionManager as JSessionManager
from repro_torch import convert
from repro_torch.crypto import rlwe as tr
from repro_torch.data import synth as tsynth
from repro_torch.retrieval import index as tindex
from repro_torch.retrieval.index import ClusterMap, FlatIndex, IvfConfig
from repro_torch.retrieval.topk import (cluster_topk, distributed_topk,
                                        plan_nprobe)
from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                               ServeEngine, SessionManager, batching)
from repro_torch.serve.session import PlanCache

N_DOCS, DIM, K = 600, 64, 4
N_NEW = 72          # ingested tail
N_REQ = 6
NUM_CLUSTERS = 6
TENANTS = ("alice", "bob", "carol")
JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)
SEED = 0


def _corpus(rng):
    """The reference's corpus: planted duplicate rows, so equal scores
    land in different clusters and replica slices after the permutation."""
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    emb[450] = emb[10]
    emb[300] = emb[10]
    return emb


def _docs():
    return [f"passage-{i}".encode() for i in range(N_DOCS)]


def _build(rng=None, **ivf_kw):
    emb = _corpus(rng or np.random.default_rng(SEED))
    return FlatIndex.build(emb, documents=_docs(), normalize=False,
                           ivf=IvfConfig(num_clusters=NUM_CLUSTERS,
                                         seed=SEED, **ivf_kw),
                           device="cpu")


def _tail(rng):
    emb = synth.uniform_corpus(rng, N_NEW, DIM)
    return emb, [f"ingested-{i}".encode() for i in range(N_NEW)]


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(SEED + 1)
    emb = _corpus(np.random.default_rng(SEED))
    q = synth.queries_near_corpus(rng, emb, N_REQ)
    q[2] = emb[10]          # aim one query straight at the duplicated row
    return q


@pytest.fixture(scope="module")
def static_index():
    return _build()


def _ids_equal_up_to_ties(got, want, q, emb, tol=1e-5):
    for b, pos in zip(*np.nonzero(got != want)):
        s_got = float(emb[got[b, pos]].astype(np.float64) @ q[b])
        s_want = float(emb[want[b, pos]].astype(np.float64) @ q[b])
        assert abs(s_got - s_want) <= tol, (b, pos, s_got, s_want)


# ---------------------------------------------------------------------------
# retrieval layer against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_clusters,align,iters",
                         [(6, 1, 8), (6, 50, 8), (4, 64, 3), (1, 1, 8)])
def test_kmeans_perm_and_cluster_map_match_reference(num_clusters, align,
                                                     iters):
    emb = _corpus(np.random.default_rng(SEED))
    perm, cm = tindex._kmeans_cluster_map(
        emb, IvfConfig(num_clusters=num_clusters, align=align, iters=iters,
                       seed=SEED))
    jperm, jcm = jindex._kmeans_cluster_map(
        emb, jindex.IvfConfig(num_clusters=num_clusters, align=align,
                              iters=iters, seed=SEED))
    np.testing.assert_array_equal(perm, jperm)
    for f in ("centroids", "starts", "stops"):
        a, b = getattr(cm, f), getattr(jcm, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert all(int(s) % align == 0 for s in cm.starts)


def test_ivf_index_matches_reference(static_index):
    emb = _corpus(np.random.default_rng(SEED))
    jidx = jindex.FlatIndex.build(emb, documents=_docs(), normalize=False,
                                  ivf=jindex.IvfConfig(
                                      num_clusters=NUM_CLUSTERS, seed=SEED))
    np.testing.assert_array_equal(static_index.embeddings.numpy(),
                                  np.asarray(jidx.embeddings))
    assert static_index.documents == jidx.documents
    cm = static_index.cluster_map
    assert cm.num_clusters == NUM_CLUSTERS and int(cm.sizes.sum()) == N_DOCS
    assert np.array_equal(cm.starts[1:], cm.stops[:-1])
    assert static_index.epoch == 0
    assert static_index.corpus_view().cluster_map is cm
    q = np.eye(3, DIM, dtype=np.float32)
    np.testing.assert_array_equal(cm.route(q, 4), jidx.cluster_map.route(q, 4))


@pytest.mark.parametrize("kprime,slack", [(1, 4.0), (8, 4.0), (40, 4.0),
                                          (161, 1.0), (N_DOCS, 4.0),
                                          (3, 1e9)])
def test_plan_nprobe_matches_reference(static_index, kprime, slack):
    cm = static_index.cluster_map
    assert plan_nprobe(cm, kprime, slack=slack) == jtopk.plan_nprobe(
        cm, kprime, slack=slack)


def test_plan_nprobe_bounds_and_cluster_topk_requires_ivf(static_index):
    cm = static_index.cluster_map
    assert plan_nprobe(cm, 1) >= 1
    assert plan_nprobe(cm, N_DOCS) == NUM_CLUSTERS
    assert plan_nprobe(cm, 1, slack=1e9) == NUM_CLUSTERS
    with pytest.raises(ValueError):
        plan_nprobe(cm, 0)
    flat = FlatIndex.build(_corpus(np.random.default_rng(SEED)),
                           normalize=False, device="cpu")
    with pytest.raises(ValueError, match="IVF"):
        cluster_topk(flat.corpus_view(), np.zeros((1, DIM), np.float32), K)
    with pytest.raises(ValueError, match="raise nprobe"):
        cluster_topk(static_index.corpus_view(),
                     np.zeros((1, DIM), np.float32), N_DOCS, nprobe=1)


@pytest.mark.parametrize("nprobe", [1, 2, 3, None])
def test_cluster_topk_matches_reference(static_index, queries, nprobe):
    emb = _corpus(np.random.default_rng(SEED))
    jidx = jindex.FlatIndex.build(emb, normalize=False,
                                  ivf=jindex.IvfConfig(
                                      num_clusters=NUM_CLUSTERS, seed=SEED))
    got = cluster_topk(static_index.corpus_view(), queries, 2 * K,
                       nprobe=nprobe)
    want = jtopk.cluster_topk(jidx.corpus_view(), queries, 2 * K,
                              nprobe=nprobe)
    assert got.exact == bool(want.exact) == (nprobe is None)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-6)
    _ids_equal_up_to_ties(got.indices.numpy(), np.asarray(want.indices),
                          queries, static_index.embeddings.numpy())


# ---------------------------------------------------------------------------
# the port's own retrieval contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nprobe", [None, NUM_CLUSTERS, NUM_CLUSTERS + 3])
def test_nprobe_all_is_bit_identical_to_flat_scan(static_index, queries,
                                                  nprobe):
    view = static_index.corpus_view()
    flat = distributed_topk(static_index, queries, 2 * K)
    routed = cluster_topk(view, queries, 2 * K, nprobe=nprobe)
    assert torch.equal(routed.indices, flat.indices)
    assert torch.equal(routed.values.view(torch.int32),
                       flat.values.view(torch.int32))
    assert routed.exact
    # the duplicated row's three copies tie and come in id order
    row = static_index.embeddings[int(flat.indices[2, 0])]
    ties = torch.nonzero((static_index.embeddings == row).all(1)).flatten()
    assert ties.numel() == 3
    assert flat.indices[2, :3].tolist() == sorted(ties.tolist())


def test_small_nprobe_recall_at_planned_bound():
    """On a clustered corpus the planner-derived nprobe recovers the flat
    scan's top-k, while ``exact`` reports the skipped rows."""
    rng = np.random.default_rng(SEED)
    centers = rng.normal(size=(NUM_CLUSTERS, DIM))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = np.repeat(centers, N_DOCS // NUM_CLUSTERS, axis=0)
    emb = emb + 0.05 * rng.normal(size=emb.shape)
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(
        np.float32)
    idx = FlatIndex.build(emb, normalize=False, device="cpu",
                          ivf=IvfConfig(num_clusters=NUM_CLUSTERS,
                                        seed=SEED))
    view = idx.corpus_view()
    q = synth.queries_near_corpus(np.random.default_rng(SEED + 1), emb,
                                  N_REQ).astype(np.float32)
    nprobe = plan_nprobe(view.cluster_map, 2 * K)
    assert 1 <= nprobe < NUM_CLUSTERS
    routed = cluster_topk(view, q, K, nprobe=nprobe)
    assert not routed.exact
    assert torch.equal(routed.indices, distributed_topk(idx, q, K).indices)


def test_clustered_corpus_matches_reference():
    a = tsynth.clustered_corpus(np.random.default_rng(3), 200, DIM,
                                n_clusters=8)
    b = synth.clustered_corpus(np.random.default_rng(3), 200, DIM,
                               n_clusters=8)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_ingest_advances_epoch_and_appends_tail_cluster(queries):
    idx = _build()
    jidx = jindex.FlatIndex.build(
        _corpus(np.random.default_rng(SEED)), documents=_docs(),
        normalize=False,
        ivf=jindex.IvfConfig(num_clusters=NUM_CLUSTERS, seed=SEED))
    new_emb, new_docs = _tail(np.random.default_rng(SEED + 2))
    before = distributed_topk(idx, queries, 2 * K)
    v1 = idx.ingest(new_emb, documents=new_docs, normalize=False)
    jidx.ingest(new_emb, documents=new_docs, normalize=False)
    assert (idx.epoch, v1.epoch) == (1, 1)
    assert v1.num_rows == N_DOCS + N_NEW
    assert v1.cluster_map.num_clusters == NUM_CLUSTERS + 1
    assert int(v1.cluster_map.starts[-1]) == N_DOCS
    assert idx.documents[N_DOCS:] == new_docs
    for f in ("centroids", "starts", "stops"):
        assert np.array_equal(getattr(v1.cluster_map, f),
                              getattr(jidx.cluster_map, f)), f
    # epoch-0 view: old geometry, old bits
    v0 = idx.corpus_view(0)
    assert v0.num_rows == N_DOCS
    assert v0.cluster_map.num_clusters == NUM_CLUSTERS
    replay = cluster_topk(v0, queries, 2 * K)
    assert torch.equal(replay.indices, before.indices)
    assert torch.equal(replay.values, before.values)
    # grown corpus: routed == flat over all N_DOCS + N_NEW rows
    after_flat = distributed_topk(idx, queries, 2 * K)
    after_routed = cluster_topk(v1, queries, 2 * K)
    assert torch.equal(after_routed.indices, after_flat.indices)
    with pytest.raises(ValueError, match="epoch"):
        idx.corpus_view(2)


def test_fixed_epoch_replay_under_concurrent_ingestion(queries):
    idx = _build()
    v0 = idx.corpus_view()
    want = cluster_topk(v0, queries, 2 * K)
    stop = threading.Event()
    errs = []

    def writer():
        rng = np.random.default_rng(SEED + 3)
        try:
            for _ in range(6):
                emb, docs = _tail(rng)
                idx.ingest(emb, documents=docs, normalize=False)
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=writer)
    t.start()
    rounds = 0
    while not stop.is_set() or rounds == 0:
        got = cluster_topk(v0, queries, 2 * K)
        assert torch.equal(got.indices, want.indices), "replay drifted"
        assert torch.equal(got.values, want.values), "replay drifted"
        rounds += 1
    t.join()
    assert not errs
    assert idx.epoch == 6 and idx.num_rows == N_DOCS + 6 * N_NEW
    got = cluster_topk(idx.corpus_view(0), queries, 2 * K)
    assert torch.equal(got.indices, want.indices)


def test_ingest_validation():
    idx = _build()
    with pytest.raises(ValueError):
        idx.ingest(np.zeros((3, DIM + 1), np.float32))      # dim mismatch
    docless = FlatIndex.build(_corpus(np.random.default_rng(SEED)),
                              normalize=False, device="cpu")
    with pytest.raises(ValueError, match="without documents"):
        docless.ingest(np.zeros((3, DIM), np.float32),
                       documents=[b"a", b"b", b"c"])
    assert docless.epoch == 0 and docless.num_rows == N_DOCS
    assert idx.ingest(np.zeros((0, DIM), np.float32)).epoch == 0


def test_ingest_drops_dense_and_grows_sharded_caches():
    idx = _build()
    cfg = tr.CandidateCacheConfig(shard_docs=64)
    dense = idx.candidate_cache(TP)
    sh = idx.candidate_cache(TP, cfg)
    new_emb, new_docs = _tail(np.random.default_rng(SEED + 2))
    idx.ingest(new_emb, documents=new_docs, normalize=False)
    assert idx.peek_candidate_cache(TP) is None          # dropped
    assert idx.peek_candidate_cache(TP, cfg) is sh
    assert (sh.epoch, sh.num_docs, sh.ingests) == (1, N_DOCS + N_NEW, 1)
    rebuilt = idx.candidate_cache(TP)
    assert rebuilt is not dense and rebuilt.num_docs == N_DOCS + N_NEW
    ids = np.array([[0, 599, 600, N_DOCS + N_NEW - 1]])
    assert torch.equal(sh.gather(ids), rebuilt.polys[torch.from_numpy(ids)])
    sh.close()


# ---------------------------------------------------------------------------
# sharded candidate cache: the tail shard
# ---------------------------------------------------------------------------

def _sharded_cache(emb, shard_docs=64):
    dense = tr.build_candidate_cache(TP, torch.from_numpy(emb))
    return tr.shard_candidate_cache(
        dense, tr.CandidateCacheConfig(shard_docs=shard_docs))


def test_ingest_tail_matches_reference_pack_and_full_cache():
    rng = np.random.default_rng(SEED)
    emb = _corpus(rng)
    new_emb, _ = _tail(rng)
    sh = _sharded_cache(emb)
    ids = np.array([[0, 5, 599], [123, 64, 7]])
    before = sh.gather(ids)
    tail = tr._pack_corpus_ntt(TP, torch.from_numpy(new_emb), host=True)
    np.testing.assert_array_equal(tail, np.asarray(
        jr._pack_corpus_ntt(JP, new_emb)))
    sh.ingest_tail(tail, epoch=1)
    assert (sh.epoch, sh.num_docs) == (1, N_DOCS + N_NEW)
    assert sh.stats()["ingests"] == 1
    assert sh.num_shards == -(-N_DOCS // 64) + 1
    assert sh.shard_of(N_DOCS - 1) == sh.num_shards - 2
    assert sh.shard_of(N_DOCS) == sh.num_shards - 1
    assert torch.equal(sh.gather(ids), before)
    full = _sharded_cache(np.concatenate([emb, new_emb]))
    tail_ids = np.array([[N_DOCS, N_DOCS + N_NEW - 1, 60]])
    assert torch.equal(sh.gather(tail_ids), full.gather(tail_ids))
    np.testing.assert_array_equal(sh.host_pool(), full.host_pool())
    with pytest.raises(ValueError, match="stale"):
        sh.ingest_tail(tail[:2], epoch=1)
    with pytest.raises(ValueError, match="tail shard rows"):
        sh.ingest_tail(tail[:, :, :1], epoch=2)
    with pytest.raises(IndexError):
        sh.gather(np.array([[N_DOCS + N_NEW]]))
    sh.close()
    full.close()


def test_mid_ingestion_gather_never_half_swapped():
    rng = np.random.default_rng(SEED)
    emb = _corpus(rng)
    new_emb, _ = _tail(rng)
    sh = _sharded_cache(emb)
    ids = np.array([[0, 63, 64, 599]])
    want = sh.gather(ids)
    mid = {}

    def hook(cache):
        assert cache.num_docs == N_DOCS      # not yet published
        mid["gather"] = cache.gather(ids)

    sh._ingest_hook = hook
    stop = threading.Event()
    errs = []

    def reader():
        try:
            while not stop.is_set():
                if not torch.equal(sh.gather(ids), want):
                    errs.append("old-id gather drifted during ingest")
                    return
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(repr(e))

    t = threading.Thread(target=reader)
    t.start()
    sh.ingest_tail(tr._pack_corpus_ntt(TP, torch.from_numpy(new_emb),
                                       host=True), epoch=1)
    stop.set()
    t.join()
    assert not errs
    assert torch.equal(mid["gather"], want)
    assert torch.equal(sh.gather(ids), want)
    assert sh.num_docs == N_DOCS + N_NEW
    sh.close()


# ---------------------------------------------------------------------------
# serving: refresh, plan-cache epoch stamp, the differential sweep
# ---------------------------------------------------------------------------

def _sessions():
    return SessionManager(rlwe_params=TP, deterministic_seeds=True,
                          device="cpu")


def _open_all(srv, *, N=N_DOCS):
    for t in TENANTS:
        srv.open_session(t, n=DIM, N=N, k=K, plan_kwargs={"kprime": 8})


def _submit_all(srv, queries):
    return [srv.submit(TENANTS[i % len(TENANTS)], q, key=i)
            for i, q in enumerate(queries)]


def _assert_identical(want, got):
    assert sorted(r.request_id for r in got) == \
        sorted(r.request_id for r in want)
    by_rid = {r.request_id: r for r in want}
    for rb in got:
        rs = by_rid[rb.request_id]
        assert rb.ok and rs.tenant == rb.tenant
        assert np.asarray(rs.ids).tolist() == rb.ids.tolist()
        assert rs.docs == rb.docs
        assert rs.transcript.total_bytes == rb.transcript.total_bytes


def test_plan_cache_epoch_stamp_and_refresh_corpus(queries):
    pc = PlanCache()
    a = pc.get(n=DIM, N=N_DOCS, k=K, radius=0.05)
    assert pc.get(n=DIM, N=N_DOCS, k=K, radius=0.05) is a
    c = pc.get(n=DIM, N=N_DOCS, k=K, radius=0.05, epoch=1)
    assert c is not None and (pc.hits, pc.misses, len(pc)) == (1, 2, 2)
    idx = _build()
    eng = ServeEngine(idx, config=EngineConfig(max_batch=3,
                                               max_wait_s=30.0),
                      sessions=_sessions())
    assert eng.view.epoch == 0
    pcache = eng.sessions.plan_cache
    eng.open_session("alice", n=DIM, N=N_DOCS, k=K, radius=0.05)
    eng.open_session("bob", n=DIM, N=N_DOCS, k=K, radius=0.05)
    assert (pcache.hits, pcache.misses) == (1, 1)
    tail = np.asarray(queries, np.float32)   # exact copies of the queries
    idx.ingest(tail, documents=[f"hot-{i}".encode()
                                for i in range(len(tail))], normalize=False)
    q = torch.from_numpy(tail)
    pinned = eng._search_topk(q, 2 * K)
    assert pinned.max() < N_DOCS            # new rows invisible pre-refresh
    view = eng.refresh_corpus()
    assert view.epoch == 1 and eng.view.num_rows == N_DOCS + len(tail)
    # same knobs, new epoch stamp: planned afresh, not served stale
    eng.open_session("carol", n=DIM, N=N_DOCS, k=K, radius=0.05)
    assert (pcache.hits, pcache.misses) == (1, 2)
    refreshed = eng._search_topk(q, 2 * K)
    for i in range(len(tail)):
        assert N_DOCS + i in refreshed[i]   # each query finds its copy
    assert eng.refresh_corpus(0).num_rows == N_DOCS
    eng.close()


_FLAT = {}      # max_batch -> the flat engine's results before the ingest


def _flat_reference(queries, max_batch):
    if max_batch not in _FLAT:
        idx = _build()
        eng = ServeEngine(idx, config=EngineConfig(max_batch=max_batch,
                                                   max_wait_s=30.0),
                          sessions=_sessions())
        _open_all(eng)
        _submit_all(eng, queries)
        _FLAT[max_batch] = eng.drain()
        eng.close()
    return _FLAT[max_batch]


@pytest.mark.parametrize("max_batch", [1, 3, 8])
@pytest.mark.parametrize("num_replicas", [1, 2, 4])
def test_differential_sweep(queries, max_batch, num_replicas):
    """A router over the IVF corpus (cluster-aligned slices, engines at
    nprobe = all) equals the flat engine, and a tail ingested after the
    router pinned its view changes nothing."""
    want = _flat_reference(queries, max_batch)
    idx = _build()
    rt = ReplicaRouter(idx, config=RouterConfig(
        num_replicas=num_replicas,
        engine=EngineConfig(max_batch=max_batch, max_wait_s=30.0,
                            nprobe=NUM_CLUSTERS)), sessions=_sessions())
    starts = {int(s) for s in idx.cluster_map.starts}
    assert all(h.sl.start in starts for h in rt.replicas)
    _open_all(rt)
    new_emb, new_docs = _tail(np.random.default_rng(SEED + 2))
    idx.ingest(new_emb, documents=new_docs, normalize=False)
    assert idx.epoch == 1 and rt.view.epoch == 0
    _submit_all(rt, queries)
    got = rt.drain()
    rt.close()
    _assert_identical(want, got)
    assert rt.metrics.summary()["scatter_calls"] > 0


def _jax_perturb(generators, E, epss, *, device=None):
    """The reference engine's perturbation of the same requests: the
    port's generator seed is the reference's PRNGKey seed."""
    keys = [jax.random.PRNGKey(g.initial_seed()) for g in generators]
    return torch.from_numpy(np.array(jbatching.perturb_batch(keys, E, epss)))


def test_ivf_router_matches_reference_engine(queries, monkeypatch):
    """Per request, the port's router over the IVF corpus at the planned
    nprobe equals the reference's engine at the same nprobe (ids,
    documents, wire bytes), with the reference's perturbations."""
    emb = _corpus(np.random.default_rng(SEED))
    jidx = jindex.FlatIndex.build(emb, documents=_docs(), normalize=False,
                                  ivf=jindex.IvfConfig(
                                      num_clusters=NUM_CLUSTERS, seed=SEED))
    nprobe = jtopk.plan_nprobe(jidx.cluster_map, 8)
    assert nprobe < NUM_CLUSTERS
    jeng = JServeEngine(
        jidx, config=JEngineConfig(max_batch=3, max_wait_s=30.0,
                                   nprobe=nprobe),
        sessions=JSessionManager(rlwe_params=JP, deterministic_seeds=True))
    for t in TENANTS:
        jeng.open_session(t, n=DIM, N=N_DOCS, k=K, plan_kwargs={"kprime": 8})
    for i, q in enumerate(queries):
        jeng.submit(TENANTS[i % len(TENANTS)], q, key=jax.random.PRNGKey(i))
    want = jeng.drain()
    jeng.close()

    monkeypatch.setattr(batching, "perturb_batch", _jax_perturb)
    jcm = jidx.cluster_map
    idx = convert.flat_index(
        np.asarray(jidx.embeddings), jidx.documents, device="cpu",
        cluster_map=convert.cluster_map(jcm.centroids, jcm.starts,
                                        jcm.stops))
    assert plan_nprobe(idx.cluster_map, 8) == nprobe
    eng = ServeEngine(idx, config=EngineConfig(max_batch=3, max_wait_s=30.0,
                                               nprobe=nprobe),
                      sessions=_sessions())
    _open_all(eng)
    _submit_all(eng, queries)
    _assert_identical(want, eng.drain())
    eng.close()
    rt = ReplicaRouter(idx, config=RouterConfig(
        num_replicas=2, engine=EngineConfig(max_batch=3, max_wait_s=30.0,
                                            nprobe=NUM_CLUSTERS)),
        sessions=_sessions())
    _open_all(rt)
    _submit_all(rt, queries)
    got = rt.drain()
    rt.close()
    # the router scans every cluster: its candidates hold the routed ones
    _assert_identical(_flat_reference(queries, 3), got)


def test_router_replan_preserves_merge_order(queries):
    """After ingest + replan the scatter merge equals a whole-corpus scan of
    the grown corpus, and the protocol through the replanned router equals
    a fresh single engine at the new epoch."""
    idx = _build()
    rt = ReplicaRouter(idx, config=RouterConfig(
        num_replicas=2, engine=EngineConfig(max_batch=3, max_wait_s=30.0)),
        sessions=_sessions())
    new_emb, new_docs = _tail(np.random.default_rng(SEED + 2))
    idx.ingest(new_emb, documents=new_docs, normalize=False)
    spans = rt.replan()
    assert rt.view.epoch == 1
    assert spans[0][0] == 0 and spans[-1][1] == N_DOCS + N_NEW
    stops = {int(s) for s in idx.cluster_map.stops} | {0}
    assert all(start in stops for start, _ in spans)
    q32 = np.asarray(queries, np.float32)
    merged = rt._scatter_topk(q32, 2 * K, home=0)
    flat = distributed_topk(idx, q32, 2 * K)
    assert np.array_equal(merged, flat.indices.numpy())
    _open_all(rt, N=N_DOCS + N_NEW)
    _submit_all(rt, queries)
    got = rt.drain()
    rt.close()
    eng = ServeEngine(idx, config=EngineConfig(max_batch=3, max_wait_s=30.0),
                      sessions=_sessions())
    _open_all(eng, N=N_DOCS + N_NEW)
    _submit_all(eng, queries)
    want = eng.drain()
    eng.close()
    _assert_identical(want, got)


def test_cluster_map_appended_and_converted():
    cm = ClusterMap(centroids=np.eye(2, DIM, dtype=np.float32),
                    starts=np.array([0, 30]), stops=np.array([30, 60]))
    cm2 = cm.appended(np.ones(DIM, np.float32), 60, 75)
    assert cm2.num_clusters == 3
    assert (int(cm2.starts[-1]), int(cm2.stops[-1])) == (60, 75)
    assert cm.num_clusters == 2             # immutable original
    assert cm2.trimmed(60).num_clusters == 2 and cm2.trimmed(75) is cm2
    emb = _corpus(np.random.default_rng(SEED))[:75]
    idx = convert.flat_index(emb, device="cpu", cluster_map=cm2,
                             epoch_rows=[60, 75])
    assert idx.epoch == 1 and idx.corpus_view(0).num_rows == 60
    assert idx.corpus_view(0).cluster_map.num_clusters == 2
    with pytest.raises(ValueError, match="epoch rows"):
        convert.flat_index(emb, device="cpu", epoch_rows=[60, 70])
