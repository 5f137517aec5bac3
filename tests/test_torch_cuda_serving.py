"""The port's serving paths on the card: the round one request at a time
and batched, the sharded cache, the engine, the Paillier backend and the
paper's baselines, the IVF corpus under ingestion, and text queries.

Marked ``cuda``: on a host without a CUDA device every test here skips.
The paper's point (10^6 x 768, k' = 161) and the two-tower round (10^6 x
256, k' = 6,795) run in the benchmark's cells, whose ``correct`` holds
recall, documents and wire bytes there; these tests hold the same paths
at 2^17 documents (the IVF corpus too, with a 5 % ingest), where each
path's result does not depend on the corpus's size.  Every path runs with
the kernels' launch counts set to 0 just before it, and every kernel of
the path must have launched.
"""

import gc
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import remoterag
from repro_torch.core import planner, protocol
from repro_torch.crypto import rlwe
from repro_torch.data import synth
from repro_torch.kernels import ext
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import (EngineConfig, ServeEngine, SessionManager,
                               batching)

pytestmark = pytest.mark.cuda

N_DOCS = 2**17
REQUESTS, TENANTS = 8, 4
NUM_SHARDS, BUDGET_SHARDS = 16, 4
# kernels of the RLWE serving path: encryption and decryption make one key
# product each, scoring forward-NTTs the query and runs the fused re-rank;
# the standalone inverse NTT and pointwise product (fresh packing's staged
# scoring) and the staged re-rank (the witness) must not launch there
PATH_KERNELS = ("ntt_fwd", "key_mul", "fused_rerank_intt", "score_topk")
OFF_PATH_KERNELS = ("ntt_inv", "pointwise_mul", "fused_rerank")


def assert_launched(counts, kernels=PATH_KERNELS):
    """Every kernel of the path launched in ``counts`` (one path's run);
    on the RLWE serving path, none of `OFF_PATH_KERNELS`."""
    for kern in kernels:
        assert counts.get(kern, 0) > 0, (kern, counts)
    if kernels == PATH_KERNELS:
        for kern in OFF_PATH_KERNELS:
            assert counts.get(kern, 0) == 0, (kern, counts)


def launches(fn):
    """(fn(), the kernel launches it made)."""
    torch.cuda.synchronize()
    ext.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, ext.launch_counts()


def same_result(a, b) -> bool:
    """Two ServeResults agree: request id, tenant, ids, documents, bytes."""
    return (a.request_id == b.request_id and a.tenant == b.tenant
            and a.ids.tolist() == b.ids.tolist() and a.docs == b.docs
            and all(getattr(a.transcript, f) == getattr(b.transcript, f)
                    for f in ("total_bytes", "request_bytes",
                              "reply_bytes")))


def recall(ids, want) -> float:
    return len(set(np.asarray(ids).tolist()) & set(want.tolist())) / len(want)


@pytest.fixture(scope="module")
def flat(cuda):
    """The paper's service config (`configs/remoterag.py`: 768 dims, k =
    5, the k' = 160 knob, the RLWE ring) over N_DOCS uniform documents:
    the index and its dense candidate cache on the card, 8 queries near
    corpus rows and their plaintext top-5."""
    cfg = remoterag
    corpus = synth.uniform_corpus(np.random.default_rng(0), N_DOCS, cfg.DIM)
    queries = synth.queries_near_corpus(np.random.default_rng(1), corpus,
                                        REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(N_DOCS)]
    index = FlatIndex.build(corpus, documents=docs, device=cuda)
    del corpus
    plan = planner.plan(n=cfg.DIM, N=N_DOCS, k=cfg.K, kprime=cfg.KPRIME)
    cloud = protocol.RemoteRagCloud(index, rlwe_params=cfg.RLWE)
    cloud.candidate_cache                               # built here
    q = torch.from_numpy(queries).to(cuda)
    plain = torch.matmul(q, index.embeddings.T)
    want = torch.sort(-plain, dim=1, stable=True)[1][:, :cfg.K].cpu().numpy()
    yield types.SimpleNamespace(cfg=cfg, index=index, cloud=cloud, plan=plan,
                                queries=queries, docs=docs, want=want)
    del index, cloud
    gc.collect()
    torch.cuda.empty_cache()


def open_tenants(srv, flat, prefix="tenant", **kw) -> None:
    for t in range(TENANTS):
        srv.open_session(f"{prefix}-{t}", n=flat.index.dim,
                         N=flat.index.num_rows, k=flat.cfg.K,
                         plan_kwargs={"kprime": flat.cfg.KPRIME}, **kw)


def serve(srv, queries, keys, tenant, kernels=PATH_KERNELS):
    """Submit ``queries[j]`` under ``keys[j]`` for ``tenant(j)`` and drain;
    every request must succeed and every kernel of the path launch."""
    def run():
        for j, (q, key) in enumerate(zip(queries, keys)):
            srv.submit(tenant(j), q, key=key)
        return srv.drain()

    res, counts = launches(run)
    assert len(res) == len(queries) and all(r.ok for r in res), [
        r.error for r in res if not r.ok]
    assert_launched(counts, kernels)
    return res


def test_round_one_at_a_time_equals_batch_on_card(cuda, flat):
    """8 requests of 4 tenants through ``run_remoterag`` one at a time, and
    again as one batch (perturb_batch -> topk_batch -> encrypted_scores_
    cached_batch -> decrypt_scores_batch -> finish_request): equal ids,
    documents and wire bytes; the documents of the ids; recall@5 = 1.0
    against the plaintext top-5; decrypted scores within 2e-3 of the
    plaintext inner products."""
    params, plan, queries = flat.cfg.RLWE, flat.plan, flat.queries
    index, cloud = flat.index, flat.cloud

    def users():
        return [protocol.RemoteRagUser(
            n=index.dim, N=index.num_rows, k=plan.k, plan=plan,
            rlwe_params=params, rng=np.random.default_rng(100 + t),
            device=cuda) for t in range(TENANTS)]

    def gens():
        return [torch.Generator(device=cuda).manual_seed(1000 + j)
                for j in range(REQUESTS)]

    seq_users = users()
    seq, counts = launches(lambda: [protocol.run_remoterag(
        seq_users[j % TENANTS], cloud, queries[j], g)
        for j, g in enumerate(gens())])
    assert_launched(counts)

    b_users = users()
    lanes = [b_users[j % TENANTS] for j in range(REQUESTS)]

    def batch():
        pert = batching.perturb_batch(gens(), queries, [plan.eps] * REQUESTS,
                                      device=cuda)
        res = batching.topk_batch(index, pert, plan.kprime)
        enc = [u.encrypt_query(e) for u, e in zip(lanes, queries)]
        sc = batching.encrypted_scores_cached_batch(
            params, enc, cloud.candidate_cache, res.indices)
        scores = batching.decrypt_scores_batch([u.sk for u in lanes], sc)
        cand = res.indices.cpu().numpy()
        out = []
        for j, u in enumerate(lanes):
            req = protocol.Request(perturbed=pert[j], kprime=plan.kprime,
                                   enc_query=enc[j], backend="rlwe")
            reply = protocol.Reply(candidate_ids=cand[j],
                                   enc_scores=sc.lane(j))
            out.append(protocol.finish_request(
                u, cloud, req, reply,
                u.positions_from_scores(scores[j], plan.kprime)))
        return out, cand, scores

    (got, cand, scores), counts = launches(batch)
    assert_launched(counts)
    q = torch.from_numpy(queries).to(cuda)
    for j in range(REQUESTS):
        docs_s, ids_s, tr_s = seq[j]
        docs_b, ids_b, tr_b = got[j]
        assert np.array_equal(ids_s, ids_b) and docs_s == docs_b
        assert tr_s.total_bytes == tr_b.total_bytes
        assert docs_s == [f"passage-{int(i)}".encode() for i in ids_s]
        assert recall(ids_s, flat.want[j]) == 1.0, j
        truth = (index.rows(cand[j]).double() @ q[j].double()).cpu().numpy()
        assert np.abs(scores[j] - truth).max() <= 2e-3


def test_sharded_cache_scores_equal_dense_on_card(cuda, flat):
    """The dense cache re-viewed as a 16-shard sharded cache: cached scores
    through it equal the dense cache's bit for bit with no shard resident
    (host row gathers), with two shards pinned (device gathers, no miss),
    and under asynchronous admission, in flight and then resident."""
    params, plan, index = flat.cfg.RLWE, flat.plan, flat.index
    cache = flat.cloud.candidate_cache
    users = [protocol.RemoteRagUser(
        n=index.dim, N=index.num_rows, k=plan.k, plan=plan,
        rlwe_params=params, rng=np.random.default_rng(100 + t), device=cuda)
        for t in range(TENANTS)]
    enc = [users[j % TENANTS].encrypt_query(e)
           for j, e in enumerate(flat.queries)]
    cand = batching.topk_batch(index, flat.queries, plan.kprime).indices
    cand = cand.cpu().numpy().astype(np.int64)
    gen = np.random.default_rng(11)

    def same_as_dense(sh, ids):
        want = rlwe.encrypted_scores_cached_batch(params, enc, cache, ids)
        got = rlwe.encrypted_scores_cached_batch(params, enc, sh, ids)
        assert torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1)

    def config(**kw):
        return rlwe.CandidateCacheConfig(num_shards=NUM_SHARDS, **kw)

    sh = rlwe.shard_candidate_cache(cache, config(max_resident_bytes=0))
    assert sh.num_shards == NUM_SHARDS
    same_as_dense(sh, cand)
    shard_docs = sh.shard_docs
    sh.close()

    sh = rlwe.shard_candidate_cache(cache, config(pin_on_access=False))
    sh.pin(0)
    sh.pin(1)
    ids = gen.integers(0, 2 * shard_docs, size=cand.shape)
    same_as_dense(sh, ids)
    assert sh.resident_shards == (0, 1) and sh.misses == 0
    sh.close()

    sh = rlwe.shard_candidate_cache(cache, config(admit_threshold=1))
    ids = gen.integers(5 * shard_docs, 6 * shard_docs, size=cand.shape)
    sh.gather(ids)                      # a miss: streams, enqueues shard 5
    same_as_dense(sh, ids)
    sh.flush()
    assert sh.resident_shards == (5,) and sh.async_admissions == 1
    same_as_dense(sh, ids)
    sh.close()


def test_engines_and_router_agree_on_card(cuda, flat):
    """16 requests of 4 tenants (the 8 queries twice) through ServeEngine:
    dense batched, dense sequential, and sharded (16 shards, a 4-shard
    device budget) batched, and through a 4-replica ReplicaRouter on the
    dense cache.  Every request returns the same request id, ids,
    documents and wire bytes in all four runs, with recall@5 = 1.0; the
    router scanned no slice twice and quarantined no replica."""
    from repro_torch.serve import ReplicaRouter, RouterConfig

    params, index = flat.cfg.RLWE, flat.index
    shard_bytes = (-(-index.num_rows // NUM_SHARDS) * params.num_chunks(
        index.dim) * params.num_primes * params.n_poly * 4)
    runs = {
        "dense_batched": EngineConfig(max_batch=8, trace=True),
        "dense_sequential": EngineConfig(max_batch=1, sequential=True,
                                         trace=True),
        "sharded_batched": EngineConfig(
            max_batch=8, trace=True, cache_config=rlwe.CandidateCacheConfig(
                num_shards=NUM_SHARDS,
                max_resident_bytes=BUDGET_SHARDS * shard_bytes)),
        "router": EngineConfig(max_batch=8),
    }
    n = 2 * REQUESTS
    reqs = [flat.queries[j % REQUESTS] for j in range(n)]
    keys = [1000 + j for j in range(n)]
    results = {}
    for name, cfg in runs.items():
        sessions = SessionManager(rlwe_params=params,
                                  deterministic_seeds=True, device=cuda)
        srv = (ReplicaRouter(index, config=RouterConfig(
            num_replicas=4, engine=cfg), sessions=sessions)
            if name == "router" else ServeEngine(index, config=cfg,
                                                 sessions=sessions))
        open_tenants(srv, flat)
        res = serve(srv, reqs, keys, lambda j: f"tenant-{j % TENANTS}")
        if name == "router":
            fleet = srv.summary()["router"]
            assert fleet["fallback_scans"] == 0, fleet
            assert not fleet["quarantines"], fleet
        srv.close()
        assert [recall(r.ids, flat.want[r.request_id % REQUESTS])
                for r in res] == [1.0] * n, name
        results[name] = res
    for name, res in results.items():
        for a, b in zip(results["dense_batched"], res):
            assert same_result(a, b), (name, b.request_id)


# -- the Paillier backend and the paper's baselines ---------------------------

PAILLIER_BITS, FALLBACK_BITS = 512, 1024   # tenants' keys; the object tier
CONSCIOUS_ROWS = 512          # rows of the privacy-conscious baselines


def paillier_engine(flat, cfg, bits, cuda):
    eng = ServeEngine(flat.index, config=cfg, sessions=SessionManager(
        deterministic_seeds=True, device=cuda))
    for tenant, b in bits.items():
        eng.open_session(tenant, n=flat.index.dim, N=flat.index.num_rows,
                         k=flat.cfg.K, backend="paillier", paillier_bits=b,
                         plan_kwargs={"kprime": flat.cfg.KPRIME})
    return eng


def assert_paillier_wire(tr, key_bits, flat):
    """The ciphertext part of a Paillier transcript equals the accounting
    model's at the key's own bit length."""
    from repro_torch.core import accounting

    dim, kprime = flat.index.dim, flat.plan.kprime
    assert (tr.request_bytes - (dim * 4 + 4)
            == accounting.paillier_query_bytes(dim, key_bits))
    assert (tr.reply_bytes - kprime * 4
            == accounting.paillier_scores_bytes(kprime, key_bits))


def test_paillier_engine_on_card(cuda, flat):
    """The Paillier backend (512-bit keys: 46 residue channels, the
    vectorized path) through a ServeEngine: 16 requests of 4 tenants
    batched, the first 4 again one at a time, equal per request, recall@5
    = 1.0, ciphertext bytes equal to the accounting model's; one request
    through ``run_remoterag`` equal to the engine's first."""
    from repro_torch.crypto import paillier_vec as pvec
    from repro_torch.kernels.bignum import ref as bref

    tenants = {f"tenant-{t}": PAILLIER_BITS for t in range(TENANTS)}
    n = 2 * REQUESTS
    reqs = [flat.queries[j % REQUESTS] for j in range(n)]
    keys = [1000 + j for j in range(n)]
    results = {}
    # one at a time, the first 4 requests: seconds of bignum launches each
    for name, cfg, count in (
            ("batched", EngineConfig(max_batch=8), n),
            ("sequential", EngineConfig(max_batch=1, sequential=True), 4)):
        eng = paillier_engine(flat, cfg, tenants, cuda)
        pub = eng.sessions.get("tenant-0").user.sk.pub
        assert bref.num_channels(pub.n_sq) == 46 and pvec.fits(pub)
        res = serve(eng, reqs[:count], keys[:count],
                    lambda j: f"tenant-{j % TENANTS}", kernels=("score_topk",))
        for r in res:
            assert_paillier_wire(r.transcript, eng.sessions.get(
                r.tenant).user.sk.pub.key_bits, flat)
        eng.close()
        results[name] = res
    for a, b in zip(results["batched"], results["sequential"]):
        assert same_result(a, b), a.request_id
    assert [recall(r.ids, flat.want[r.request_id % REQUESTS])
            for r in results["batched"]] == [1.0] * n

    user = protocol.RemoteRagUser(
        n=flat.index.dim, N=flat.index.num_rows, k=flat.plan.k,
        plan=flat.plan, backend="paillier", paillier_bits=PAILLIER_BITS,
        rng=np.random.default_rng(500), device=cuda)
    cloud = protocol.RemoteRagCloud(flat.index)
    (docs, ids, tr), counts = launches(lambda: protocol.run_remoterag(
        user, cloud, flat.queries[0],
        torch.Generator(device=cuda).manual_seed(keys[0])))
    assert_launched(counts, ("score_topk",))
    first = results["batched"][0]
    assert ids.tolist() == first.ids.tolist() and docs == first.docs
    assert_paillier_wire(tr, user.sk.pub.key_bits, flat)


def test_paillier_mixed_key_sizes_batch_on_card(cuda, flat):
    """One batch of a 1024-bit tenant (90 channels: past the vectorized
    path's budget, so the object path) beside three 512-bit ones: the lane
    counters split 3 x 3 vectorized calls and 3 object calls in one batch,
    the object lane equals its solo run and its wire bytes the model's at
    1024 bits."""
    from repro_torch.crypto import paillier_vec as pvec
    from repro_torch.kernels.bignum import ref as bref

    mixed = {"tenant-big": FALLBACK_BITS,
             **{f"tenant-{t}": PAILLIER_BITS for t in range(1, TENANTS)}}
    names = list(mixed)
    keys = [1000 + j for j in range(TENANTS)]
    pvec.reset_counters()
    eng = paillier_engine(flat, EngineConfig(max_batch=8), mixed, cuda)
    big = eng.sessions.get("tenant-big").user.sk.pub
    assert not pvec.fits(big) and bref.num_channels(big.n_sq) == 90
    res = serve(eng, flat.queries[:TENANTS], keys, lambda j: names[j],
                kernels=("score_topk",))
    eng.close()
    lanes = dict(pvec.counters)
    assert lanes == {"vectorized": 3 * (TENANTS - 1), "object": 3}, lanes
    assert res[0].batch_size == TENANTS
    solo_eng = paillier_engine(flat, EngineConfig(max_batch=1),
                               {"tenant-big": FALLBACK_BITS}, cuda)
    solo = serve(solo_eng, flat.queries[:1], keys[:1],
                 lambda j: "tenant-big", kernels=("score_topk",))
    solo_eng.close()
    assert solo[0].ids.tolist() == res[0].ids.tolist()
    assert solo[0].docs == res[0].docs
    assert_paillier_wire(res[0].transcript, big.key_bits, flat)


def test_baselines_on_card(cuda, flat):
    """The paper's baselines: the privacy-ignorant service (plaintext
    top-5 through score-top-k) equal to the plaintext top-5 up to rows
    scoring within 1e-5 of each other; the privacy-conscious service over
    CONSCIOUS_ROWS rows on both backends equal to their plaintext top-5,
    the RLWE one through its staged scoring (forward and inverse NTT,
    pointwise product, key product); the k-of-N OT over those rows
    returning the selected documents."""
    from repro_torch.core import baselines
    from repro_torch.crypto import ot as ot_mod

    index, k = flat.index, flat.cfg.K
    q = torch.from_numpy(flat.queries).to(cuda).double()
    ign, counts = launches(lambda: [
        baselines.privacy_ignorant_service(index, flat.queries[j], k)
        for j in range(REQUESTS)])
    assert_launched(counts, ("score_topk",))
    for j, b in enumerate(ign):
        got = index.embeddings[torch.as_tensor(b.ids.astype(np.int64),
                                               device=cuda)].double() @ q[j]
        want = index.embeddings[torch.as_tensor(
            flat.want[j], device=cuda)].double() @ q[j]
        assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all())

    small_docs = flat.docs[:CONSCIOUS_ROWS]
    small = FlatIndex.build(index.embeddings[:CONSCIOUS_ROWS].cpu().numpy(),
                            documents=small_docs, normalize=False,
                            device=cuda)
    s_want = torch.sort(-(small.embeddings.double() @ q[0]),
                        stable=True)[1][:k].cpu().numpy()
    for backend in ("rlwe", "paillier"):
        r, counts = launches(lambda: baselines.privacy_conscious_service(
            small, flat.queries[0], k, backend=backend,
            rng=np.random.default_rng(600), run_ot=False))
        assert r.ids.tolist() == s_want.tolist(), backend
        if backend == "rlwe":
            assert_launched(counts, ("ntt_fwd", "ntt_inv", "pointwise_mul",
                                     "key_mul"))
    width = max(len(d) for d in small_docs)
    got, _ = ot_mod.run_ot([d.ljust(width, b"\x00") for d in small_docs],
                           [int(i) for i in s_want])
    assert [d.rstrip(b"\x00") for d in got] == [small_docs[i] for i in s_want]


# -- the epoch-versioned corpus: IVF routing and ingestion --------------------

IVF_DOCS, IVF_CLUSTERS = 2**17, 16      # clusters = cache shards
INGEST_DOCS = 6_554                     # 5 % of the corpus, as 50,000 of 10^6


def plain_routed_topk(view, q, k, nprobe) -> tuple:
    """The IVF first stage through the plain version on the card: each
    query's routed clusters' rows gathered and scanned by `topk_ref`,
    global ids."""
    from repro_torch.kernels.scoretopk import ref as sref

    cm = view.cluster_map
    routed = cm.route(q.cpu().numpy(), nprobe)
    vals, ids = [], []
    for b in range(q.shape[0]):
        rows = torch.cat([torch.arange(int(cm.starts[c]), int(cm.stops[c]),
                                       device=q.device)
                          for c in sorted(int(c) for c in routed[b])])
        v, pos = sref.topk_ref(q[b:b + 1], view.embeddings[rows], k)
        vals.append(v[0])
        ids.append(rows[pos[0].long()].to(torch.int32))
    return torch.stack(vals), torch.stack(ids)


def assert_close_up_to_ties(q, emb, got, want):
    """Score-top-k results ``got`` against the plain version's ``want``:
    values within 1e-5 relative plus 1e-6; where ids differ, the row served
    scores (float64) within that tolerance of the plain value there."""
    (gv, gi), (wv, wi) = got, want
    tol = 1e-5 * wv.abs() + 1e-6
    assert bool(((gv - wv).abs() <= tol).all())
    mism = gi != wi.to(gi.dtype)
    b_idx, _ = torch.nonzero(mism, as_tuple=True)
    rescored = (q[b_idx].double() * emb[gi[mism].long()].double()).sum(-1)
    assert bool(((rescored - wv[mism].double()).abs() <= tol[mism]).all())


def test_ivf_engines_ingest_and_replan_on_card(cuda):
    """A clustered corpus (64 natural clusters) with IVF: 16 clusters
    aligned to the sharded cache's 16 shards (a 4-shard device budget).
    The routed engine at the planned nprobe serves ids from its routed
    candidates, whose first stage is not exact and equals the plain routed
    scan up to ties; a 5 % ingest on a thread while an engine pinned at
    epoch 0 replays the flat engine's 16 requests bit for bit, its pack
    launching one forward NTT a prime and block; epoch 1's tail shard
    equals the plain pack; after the refresh and the router's replan, 8
    queries near tail documents are served with recall@5 = 1.0 by the
    engine and, equal to it, by a 4-replica router."""
    from repro_torch.kernels.ntt import ref as nref
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.retrieval.index import IvfConfig
    from repro_torch.retrieval.topk import (cluster_topk, distributed_topk,
                                            plan_nprobe)
    from repro_torch.serve import ReplicaRouter, RouterConfig

    cfg = remoterag
    params, dim, n_docs = cfg.RLWE, cfg.DIM, IVF_DOCS
    shard_docs = n_docs // IVF_CLUSTERS
    corpus = synth.clustered_corpus(np.random.default_rng(0), n_docs, dim,
                                    n_clusters=64)
    queries = synth.queries_near_corpus(np.random.default_rng(1), corpus,
                                        REQUESTS)
    index = FlatIndex.build(
        corpus, documents=[f"passage-{i}".encode() for i in range(n_docs)],
        ivf=IvfConfig(num_clusters=IVF_CLUSTERS, align=shard_docs),
        device=cuda)
    del corpus
    cm = index.cluster_map
    assert cm.num_clusters == IVF_CLUSTERS
    assert all(int(a) % shard_docs == 0 for a in cm.starts)
    assert np.array_equal(cm.starts[1:], cm.stops[:-1])
    assert int(cm.stops[-1]) == n_docs
    plan = planner.plan(n=dim, N=n_docs, k=cfg.K, kprime=cfg.KPRIME)
    nprobe = plan_nprobe(cm, plan.kprime)
    shard_bytes = (shard_docs * params.num_chunks(dim) * params.num_primes
                   * params.n_poly * 4)
    ccfg = rlwe.CandidateCacheConfig(
        shard_docs=shard_docs, max_resident_bytes=BUDGET_SHARDS * shard_bytes)
    cache = index.candidate_cache(params, ccfg)
    assert cache.num_shards == IVF_CLUSTERS
    assert cache._starts.tolist() == cm.starts.tolist()
    # every cluster scanned = the flat scan bit for bit = the plain version
    # up to ties
    view = index.corpus_view()
    q = torch.from_numpy(queries).to(cuda)
    flat_scan = distributed_topk(index, q, plan.kprime)
    routed = cluster_topk(view, q, plan.kprime)
    assert torch.equal(routed.indices, flat_scan.indices)
    assert torch.equal(routed.values.view(torch.int32),
                       flat_scan.values.view(torch.int32))
    assert routed.exact and flat_scan.exact
    assert_close_up_to_ties(q, index.embeddings,
                            (flat_scan.values, flat_scan.indices),
                            sref.topk_ref(q, index.embeddings, plan.kprime))

    def engine(nprobe_=None):
        eng = ServeEngine(index, config=EngineConfig(
            max_batch=8, cache_config=ccfg, nprobe=nprobe_),
            sessions=SessionManager(rlwe_params=params,
                                    deterministic_seeds=True, device=cuda))
        for t in range(TENANTS):
            eng.open_session(f"tenant-{t}", n=dim, N=n_docs, k=plan.k,
                             plan_kwargs={"kprime": cfg.KPRIME})
        return eng

    n_req = 2 * REQUESTS
    reqs = [queries[j % REQUESTS] for j in range(n_req)]
    keys = [1000 + j for j in range(n_req)]

    def tenant(j):
        return f"tenant-{j % TENANTS}"

    # the routed engine, then its first stage again on its own
    # perturbations (a lane is perturb(generator(key)) whatever the batch)
    eng = engine(nprobe)
    res = serve(eng, reqs, keys, tenant)
    eng.close()
    pert = batching.perturb_batch(
        [torch.Generator(device=cuda).manual_seed(k) for k in keys],
        np.stack(reqs), [plan.eps] * n_req, device=cuda)
    first = cluster_topk(view, pert, plan.kprime, nprobe=nprobe)
    assert not first.exact
    assert_close_up_to_ties(pert, index.embeddings,
                            (first.values, first.indices),
                            plain_routed_topk(view, pert, plan.kprime,
                                              nprobe))
    cand = first.indices.cpu().numpy()
    for r in res:
        assert set(r.ids.tolist()) <= set(cand[r.request_id].tolist())

    # the flat engine at epoch 0; an engine routed over every cluster,
    # pinned at epoch 0, replays its requests while the ingest runs
    flat_eng = engine()
    res0 = serve(flat_eng, reqs, keys, tenant)
    flat_eng.close()
    pinned = engine(IVF_CLUSTERS + 1)
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=4, engine=EngineConfig(max_batch=8, cache_config=ccfg)),
        sessions=SessionManager(rlwe_params=params, deterministic_seeds=True,
                                device=cuda))
    tail = synth.clustered_corpus(np.random.default_rng(2), INGEST_DOCS, dim,
                                  n_clusters=64)
    box = {}

    def writer():
        try:
            box["view"] = index.ingest(tail, documents=[
                f"ingested-{i}".encode() for i in range(INGEST_DOCS)])
            torch.cuda.synchronize()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["error"] = e

    def replay():
        th = threading.Thread(target=writer, name="ingest")
        th.start()
        for j, (q, key) in enumerate(zip(reqs, keys)):
            pinned.submit(tenant(j), q, key=key)
        out = pinned.drain()
        th.join()
        return out

    res_d, counts = launches(replay)
    if "error" in box:
        raise box["error"]
    assert_launched(counts)
    assert all(r.ok for r in res_d)
    for a, b in zip(res0, res_d):
        assert same_result(a, b), b.request_id
    # the ingest packs its documents in blocks: a forward NTT a prime and
    # block, of row counts no request has
    chunks = params.num_chunks(dim)
    block = max(1, (1 << 24) // (chunks * params.n_poly))
    pack_rows = {min(block, INGEST_DOCS) * chunks,
                 (INGEST_DOCS % block or block) * chunks}
    ingest_ntt = sum(c for (name, shape), c in ext.launch_shapes().items()
                     if name == "ntt_fwd" and shape[0] in pack_rows)
    assert ingest_ntt == params.num_primes * -(-INGEST_DOCS // block)
    view1 = box["view"]
    assert view1.epoch == 1 and view1.num_rows == n_docs + INGEST_DOCS
    assert cache.num_shards == IVF_CLUSTERS + 1 and cache.epoch == 1
    new_rows = index.embeddings[n_docs:]
    plain_tail = rlwe._pack_corpus_ntt(params, new_rows, host=True,
                                       ntt_fwd=nref.ntt_fwd_ref)
    assert np.array_equal(cache.shards[-1], plain_tail)
    del plain_tail

    pinned.refresh_corpus()
    rt.replan()
    grown = n_docs + INGEST_DOCS
    q_tail = synth.queries_near_corpus(np.random.default_rng(3),
                                       new_rows.cpu().numpy(), REQUESTS,
                                       jitter=0.02)
    qt = torch.from_numpy(q_tail).to(cuda)
    want5 = torch.sort(-torch.matmul(qt, index.embeddings.T), dim=1,
                       stable=True)[1][:, :plan.k].cpu().numpy()
    assert bool((want5[:, 0] >= n_docs).all())   # near tail documents
    runs = {}
    for name, srv in (("engine", pinned), ("router", rt)):
        for t in range(TENANTS):
            srv.open_session(f"tenant-{t}@e1", n=dim, N=grown, k=plan.k,
                             plan_kwargs={"kprime": cfg.KPRIME})
        out = serve(srv, list(q_tail), [1500 + j for j in range(REQUESTS)],
                    lambda j: f"tenant-{j % TENANTS}@e1")
        assert [recall(r.ids, want5[r.request_id - out[0].request_id])
                for r in out] == [1.0] * REQUESTS, name
        runs[name] = out
    pinned.close()
    rt.close()
    for a, b in zip(runs["engine"], runs["router"]):
        assert a.tenant == b.tenant and a.ids.tolist() == b.ids.tolist()
        assert a.docs == b.docs
        assert a.transcript.total_bytes == b.transcript.total_bytes
    del index, cache, view, view1, new_rows
    gc.collect()
    torch.cuda.empty_cache()


# -- the text front end --------------------------------------------------------

TEXT_DOCS, TEXT_SEQ, TEXT_QUERIES = 2**17, 32, 16
EMBED_BATCH = 1024
TEXT_TIE = 2.0 ** -12         # plaintext gap the RLWE fixed point may swap


def served_ids_ok(scores, ids, k: int, tie: float) -> bool:
    """``ids`` are a plaintext top-``k`` of ``scores`` (one query's float
    scores over the corpus) up to ``tie``: every row scoring above the
    k-th best by more than ``tie`` is served, and no served row scores
    below it by more than ``tie``."""
    kth = float(scores.sort(descending=True).values[k - 1])
    served = set(int(i) for i in ids)
    clear = set((scores > kth + tie).nonzero()[:, 0].tolist())
    return (len(served) == k and clear <= served
            and all(float(scores[i]) >= kth - tie for i in served))


def test_text_queries_served_on_card(cuda):
    """The service's text front end at full width: passages built as
    ``examples/private_rag_serve.py`` builds them, tokenized by
    ``HashTokenizer(32768)`` at 32 tokens, embedded on the card by the
    768-wide, 4-layer encoder (float32, TF32 off), indexed with the dense
    cache; 16 text queries of 4 tenants (radius 0.05) batched and one at a
    time agree bit for bit, serve the documents of their ids and the
    plaintext top-5 up to rows within 2^-12 of the 5th score."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.examples.private_rag_serve import TOPICS, make_passages
    from repro_torch.models.embedder import Embedder, encoder_config

    cfg = encoder_config(dim=remoterag.DIM)
    passages = make_passages(np.random.default_rng(0), TEXT_DOCS)
    tok = HashTokenizer(cfg.vocab)
    ids = tok.encode_batch(passages, TEXT_SEQ)
    model = Embedder(cfg, generator=torch.Generator().manual_seed(0),
                     device=cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        embs = torch.cat([model.embed(ids[i:i + EMBED_BATCH])
                          for i in range(0, TEXT_DOCS, EMBED_BATCH)])
        qrng = np.random.default_rng(1)
        qtexts = [" ".join(TOPICS[j % len(TOPICS)].split()[j % 3:j % 3 + 2]
                           + [f"w{qrng.integers(0, 500)}" for _ in range(2)])
                  for j in range(TEXT_QUERIES)]
        q_embs = np.concatenate([
            model.embed(tok.encode_batch([t], TEXT_SEQ)).cpu().numpy()
            for t in qtexts])
        index = FlatIndex.build(embs.cpu().numpy(),
                                documents=[p.encode() for p in passages],
                                device=cuda)
        del embs
        scores = torch.matmul(torch.from_numpy(q_embs).to(cuda),
                              index.embeddings.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    k = remoterag.K
    keys = [1000 + j for j in range(TEXT_QUERIES)]
    results = {}
    for name, ecfg in (("batched", EngineConfig(max_batch=8)),
                       ("sequential", EngineConfig(max_batch=1,
                                                   sequential=True))):
        eng = ServeEngine(index, config=ecfg, sessions=SessionManager(
            rlwe_params=remoterag.RLWE, deterministic_seeds=True,
            device=cuda))
        for t in range(TENANTS):
            eng.open_session(f"tenant-{t}", n=cfg.d_model, N=TEXT_DOCS, k=k,
                             radius=0.05, backend="rlwe")
        results[name] = serve(eng, list(q_embs), keys,
                              lambda j: f"tenant-{j % TENANTS}")
        eng.close()
    for a, b in zip(results["batched"], results["sequential"]):
        assert same_result(a, b), b.request_id
    for r in results["batched"]:
        j = r.request_id
        assert r.docs == [passages[int(i)].encode() for i in r.ids]
        assert served_ids_ok(scores[j], r.ids, k, TEXT_TIE), (
            j, r.ids.tolist())


def test_serving_state_freed_after_close_on_card(cuda):
    """An index with its dense cache (1.6 GB), served through an engine
    that is then closed, leaves under 1 GB of it on the card once
    dropped."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    corpus = synth.uniform_corpus(np.random.default_rng(5), 2**15,
                                  remoterag.DIM)
    index = FlatIndex.build(corpus, documents=[
        f"passage-{i}".encode() for i in range(len(corpus))], device=cuda)
    eng = ServeEngine(index, config=EngineConfig(max_batch=8),
                      sessions=SessionManager(rlwe_params=remoterag.RLWE,
                                              deterministic_seeds=True,
                                              device=cuda))
    for t in range(TENANTS):
        eng.open_session(f"tenant-{t}", n=remoterag.DIM, N=len(corpus),
                         k=remoterag.K,
                         plan_kwargs={"kprime": remoterag.KPRIME})
    serve(eng, corpus[:REQUESTS], list(range(REQUESTS)),
          lambda j: f"tenant-{j % TENANTS}")
    assert torch.cuda.memory_allocated() - base > 1 << 30
    eng.close()
    del eng, index
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() - base < 1 << 30
