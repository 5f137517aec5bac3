"""The port's whole RemoteRAG round against the JAX package's.

The reference's perturbed embedding goes into the port's `Request`
(`jax.random` cannot be replayed in torch); keys and encryption draw from
the same numpy seeds, so ciphertexts are bit-identical.  The port must
return the same documents, ids and wire bytes on the direct and the OT
path, and the same `ProtocolPlan` for the same knobs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.core import planner as jplanner
from repro.core import protocol as jp
from repro.crypto import rlwe as jr
from repro.data import synth
from repro.retrieval.index import FlatIndex as JFlatIndex
from repro_torch import convert
from repro_torch.core import planner, protocol
from repro_torch.crypto import backend as tbackend
from repro_torch.crypto import rlwe as tr
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import batching

JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)


@pytest.mark.parametrize("knobs", [
    dict(n=768, N=10**6, k=5, kprime=160),     # the paper's service config
    dict(n=384, N=2000, k=5, radius=0.05),
    dict(n=64, N=500, k=3, eps=40.0),          # OT path
])
def test_plan_equal_to_reference(knobs):
    got = planner.plan(**knobs)
    want = jplanner.plan(**knobs)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.path == want.path
    if knobs.get("kprime") == 160:
        assert (got.kprime, got.path) == (161, "direct")


def _world(seed, n_docs, dim):
    rng = np.random.default_rng(seed)
    emb = synth.uniform_corpus(rng, n_docs, dim)
    docs = [f"passage-{i}".encode() for i in range(n_docs)]
    jidx = JFlatIndex.build(emb, documents=docs)
    tidx = convert.flat_index(np.asarray(jidx.embeddings), docs, device="cpu")
    return rng, emb, jidx, tidx


# a tight budget plans k' = N (every row is an OT message): keep N small
@pytest.mark.parametrize("path,n_docs,knobs", [
    ("direct", 500, dict(radius=0.05)), ("ot", 40, dict(eps=40.0))])
def test_round_matches_reference(path, n_docs, knobs):
    rng, emb, jidx, tidx = _world(3, n_docs, 64)
    ju = jp.RemoteRagUser(n=64, N=n_docs, k=3, backend="rlwe", rlwe_params=JP,
                          rng=np.random.default_rng(7), **knobs)
    tu = protocol.RemoteRagUser(n=64, N=n_docs, k=3, backend="rlwe",
                                rlwe_params=TP, rng=np.random.default_rng(7),
                                device="cpu", **knobs)
    assert ju.plan.path == tu.plan.path == path
    jcloud = jp.RemoteRagCloud(jidx, rlwe_params=JP)
    tcloud = protocol.RemoteRagCloud(tidx, rlwe_params=TP)
    e = synth.queries_near_corpus(rng, emb, 1)[0]

    jreq = ju.make_request(e, jax.random.PRNGKey(0))
    jrep = jcloud.handle_request(jreq)
    jdocs, jids, jtr = jp.finish_request(ju, jcloud, jreq, jrep,
                                         ju.top_positions(jrep))

    treq = protocol.Request(perturbed=torch.from_numpy(jreq.perturbed),
                            kprime=tu.plan.kprime,
                            enc_query=tu.encrypt_query(e), backend="rlwe")
    np.testing.assert_array_equal(treq.enc_query.c0.numpy(),
                                  np.asarray(jreq.enc_query.c0))
    trep = tcloud.handle_request(treq)
    tdocs, tids, ttr = protocol.finish_request(tu, tcloud, treq, trep,
                                               tu.top_positions(trep))
    assert tdocs == jdocs
    np.testing.assert_array_equal(tids, jids)
    assert ttr.total_bytes == jtr.total_bytes
    assert (ttr.request_bytes, ttr.reply_bytes, ttr.path) == (
        jtr.request_bytes, jtr.reply_bytes, jtr.path)
    # the candidate lists agree except where two rows' scores tie within
    # 1e-5 (the reference rounds float32 sums, the port rounds once)
    assert set(trep.candidate_ids.tolist()) == set(jrep.candidate_ids.tolist())
    q = jreq.perturbed.astype(np.float64)
    for p in np.nonzero(trep.candidate_ids != jrep.candidate_ids)[0]:
        a = emb[trep.candidate_ids[p]].astype(np.float64) @ q
        b = emb[jrep.candidate_ids[p]].astype(np.float64) @ q
        assert abs(a - b) <= 1e-5 * abs(b)


def test_run_remoterag_recall_on_cpu():
    rng, emb, _, tidx = _world(1, 2000, 96)
    user = protocol.RemoteRagUser(n=96, N=2000, k=5, radius=0.05,
                                  rlwe_params=TP, rng=rng, device="cpu")
    cloud = protocol.RemoteRagCloud(tidx, rlwe_params=TP)
    e = synth.queries_near_corpus(rng, emb, 1)[0]
    docs, ids, tr_ = protocol.run_remoterag(
        user, cloud, e, torch.Generator().manual_seed(0))
    want = np.argsort(-(emb @ e), kind="stable")[:5]
    assert set(ids.tolist()) == set(want.tolist())
    assert docs == [f"passage-{i}".encode() for i in ids]
    assert tr_.path == "direct" and tr_.fetch_bytes > 0


def test_batched_lanes_equal_one_at_a_time():
    """perturb_batch -> topk_batch -> encrypted_scores_cached_batch ->
    decrypt_scores_batch -> finish_request equals run_remoterag per lane,
    given the same generator seeds and tenant rng seeds."""
    rng, emb, _, tidx = _world(2, 1500, 48)
    queries = synth.queries_near_corpus(rng, emb, 3)
    plan = planner.plan(n=48, N=1500, k=4, radius=0.05)
    cloud = protocol.RemoteRagCloud(tidx, rlwe_params=TP)

    def users():
        return [protocol.RemoteRagUser(n=48, N=1500, k=4, plan=plan,
                                       rlwe_params=TP, device="cpu",
                                       rng=np.random.default_rng(50 + t))
                for t in range(2)]

    def gens():
        return [torch.Generator().manual_seed(900 + j) for j in range(3)]

    seq_users = users()
    seq = [protocol.run_remoterag(seq_users[j % 2], cloud, queries[j], g)
           for j, g in enumerate(gens())]
    b_users = users()
    lane_users = [b_users[j % 2] for j in range(3)]
    pert = batching.perturb_batch(gens(), queries, [plan.eps] * 3,
                                  device="cpu")
    res = batching.topk_batch(tidx, pert, plan.kprime)
    enc = [u.encrypt_query(e) for u, e in zip(lane_users, queries)]
    sc = batching.encrypted_scores_cached_batch(TP, enc, cloud.candidate_cache,
                                                res.indices)
    scores = batching.decrypt_scores_batch([u.sk for u in lane_users], sc)
    cand = res.indices.numpy()
    # the backend seam's batched methods: cached and cold give the same bits
    rlwe_be = batching.get_backend("rlwe")
    assert rlwe_be.cache_view(cloud) is cloud.candidate_cache
    for cache in (cloud.candidate_cache, None):
        alt = rlwe_be.score_candidates(cloud=cloud, users=lane_users, enc=enc,
                                       cand_ids=res.indices,
                                       kprime=plan.kprime, params=TP,
                                       cache=cache)
        assert torch.equal(alt.c0, sc.c0) and torch.equal(alt.c1, sc.c1)
    for a, b in zip(rlwe_be.decrypt_scores([u.sk for u in lane_users],
                                           sc.lanes()), scores):
        np.testing.assert_array_equal(a, b)
    for j, u in enumerate(lane_users):
        req = protocol.Request(perturbed=pert[j], kprime=plan.kprime,
                               enc_query=enc[j], backend="rlwe")
        reply = protocol.Reply(candidate_ids=cand[j], enc_scores=sc.lane(j))
        docs, ids, tr_ = protocol.finish_request(
            u, cloud, req, reply, u.positions_from_scores(scores[j],
                                                          plan.kprime))
        assert docs == seq[j][0]
        np.testing.assert_array_equal(ids, seq[j][1])
        assert tr_.total_bytes == seq[j][2].total_bytes


def test_cold_path_cloud_matches_cached():
    rng, emb, _, tidx = _world(4, 300, 40)
    e = synth.queries_near_corpus(rng, emb, 1)[0]
    out = []
    for cached in (True, False):
        user = protocol.RemoteRagUser(n=40, N=300, k=3, radius=0.05,
                                      rlwe_params=TP, device="cpu",
                                      rng=np.random.default_rng(8))
        cloud = protocol.RemoteRagCloud(tidx, rlwe_params=TP,
                                        use_candidate_cache=cached)
        out.append(protocol.run_remoterag(user, cloud, e,
                                          torch.Generator().manual_seed(3)))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])
    assert out[0][2].total_bytes == out[1][2].total_bytes


def test_only_rlwe_backend_is_registered():
    """The registry, as the reference's: RLWE and Paillier; any other
    name raises `UnknownBackend`."""
    assert tbackend.available() == ("paillier", "rlwe")
    assert tbackend.get_backend("paillier").name == "paillier"
    with pytest.raises(tbackend.UnknownBackend):
        tbackend.get_backend("ecc")
    with pytest.raises(tbackend.UnknownBackend):
        protocol.RemoteRagUser(n=8, N=100, k=2, radius=0.05,
                               backend="ecc", device="cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without an explicit device="cpu", the entry points
    raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError):
        FlatIndex.build(emb)
    with pytest.raises(RuntimeError):
        protocol.RemoteRagUser(n=4, N=4, k=1, radius=0.05, rlwe_params=TP)
    with pytest.raises(RuntimeError):
        batching.perturb_batch([torch.Generator()], emb[:1], [1.0])
    with pytest.raises(RuntimeError):
        tr.keygen(TP, np.random.default_rng(0))
    # the text front end, the attacks and the serving examples
    from repro_torch.core import attacks
    from repro_torch.data.synth import token_corpus
    from repro_torch.examples import private_rag_serve, quickstart
    from repro_torch.models import embedder, transformer

    cfg = embedder.encoder_config(dim=128, vocab=512, n_layers=1)
    with pytest.raises(RuntimeError):
        embedder.Embedder(cfg)
    with pytest.raises(RuntimeError):
        transformer.Transformer(cfg)
    aux = token_corpus(np.random.default_rng(0), 20, 8, vocab=64)
    with pytest.raises(RuntimeError):
        attacks.NearestNeighborAttack(aux=aux)
    with pytest.raises(RuntimeError):
        attacks.LinearDecoderAttack(aux=aux)
    with pytest.raises(RuntimeError):
        quickstart.main([])
    with pytest.raises(RuntimeError):
        private_rag_serve.main([])
