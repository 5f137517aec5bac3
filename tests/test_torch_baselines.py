"""The paper's baselines (`repro_torch.core.baselines`) and the wire-size
model (`repro_torch.core.accounting`) against the JAX package's, on the
CPU: the same ids and documents, the same RLWE wire bytes, and the
accounting formulas value for value, with the Paillier transcript's
ciphertext bytes equal to the model's at the key's own size."""

import numpy as np
import pytest
import torch

from repro.core import accounting as jacc
from repro.core import baselines as jbase
from repro.data import synth
from repro.retrieval.index import FlatIndex as JFlatIndex
from repro_torch import convert
from repro_torch.core import accounting as acc
from repro_torch.core import baselines, protocol

N_DOCS, DIM, K = 16, 32, 3


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    docs = [f"passage-{i}".encode() for i in range(N_DOCS)]
    jidx = JFlatIndex.build(emb, documents=docs)
    tidx = convert.flat_index(np.asarray(jidx.embeddings), docs, device="cpu")
    e = synth.queries_near_corpus(rng, emb, 1)[0]
    oracle = np.argsort(-(np.asarray(jidx.embeddings) @ e), kind="stable")[:K]
    return jidx, tidx, e, oracle


def test_privacy_ignorant_matches_reference(world):
    jidx, tidx, e, oracle = world
    got = baselines.privacy_ignorant_service(tidx, e, K)
    want = jbase.privacy_ignorant_service(jidx, e, K)
    assert got.ids.tolist() == np.asarray(want.ids).tolist() == oracle.tolist()
    assert got.docs == want.docs
    assert got.wire_bytes == want.wire_bytes
    bare = baselines.privacy_ignorant_service(tidx, e, K, fetch_docs=False)
    assert bare.docs is None and bare.wire_bytes == DIM * 4


@pytest.mark.parametrize("backend", ["rlwe", "paillier"])
def test_privacy_conscious_matches_reference(world, backend):
    """Every row scored under encryption, k-of-N OT for the documents.
    RLWE draws from one seeded stream, so its wire bytes equal the
    reference's; Paillier keys come from `secrets` (as in the reference),
    and its byte count depends only on the key size."""
    jidx, tidx, e, oracle = world
    kw = dict(backend=backend, paillier_bits=256)
    got = baselines.privacy_conscious_service(
        tidx, e, K, rng=np.random.default_rng(5), **kw)
    want = jbase.privacy_conscious_service(
        jidx, e, K, rng=np.random.default_rng(5), **kw)
    assert got.ids.tolist() == np.asarray(want.ids).tolist() == oracle.tolist()
    assert got.docs == want.docs == [f"passage-{i}".encode() for i in oracle]
    assert got.wire_bytes == want.wire_bytes
    no_ot = baselines.privacy_conscious_service(
        tidx, e, K, rng=np.random.default_rng(5), run_ot=False, **kw)
    assert no_ot.docs is None and no_ot.ids.tolist() == oracle.tolist()


def test_accounting_matches_reference():
    for n, big_n, k, kp in ((768, 10**6, 5, 160), (64, 500, 3, 11)):
        for name in ("privacy_ignorant", "remoterag_direct"):
            args = (n, k) if name == "privacy_ignorant" else (n, k, kp)
            assert getattr(acc, name)(*args) == acc.CommCost(
                **vars(getattr(jacc, name)(*args)))
        assert vars(acc.privacy_conscious(n, big_n)) == vars(
            jacc.privacy_conscious(n, big_n))
        ot = acc.remoterag_ot(n, kp)
        assert vars(ot) == vars(jacc.remoterag_ot(n, kp))
        assert acc.optimized_rounds(ot).rounds == 2.0
        assert ot.bytes_total() == jacc.remoterag_ot(n, kp).bytes_total()
        for kb in (256, 511, 512, 2048):
            assert acc.paillier_query_bytes(n, kb) == \
                jacc.paillier_query_bytes(n, kb)
            assert acc.paillier_scores_bytes(kp, kb) == \
                jacc.paillier_scores_bytes(kp, kb)
        assert acc.rlwe_query_bytes(n) == jacc.rlwe_query_bytes(n)
        assert acc.rlwe_scores_bytes(kp, n) == jacc.rlwe_scores_bytes(kp, n)
    assert acc.paillier_query_bytes(768) == 768 * 512   # 2048-bit default


def test_paillier_transcript_bytes_follow_the_model(world):
    """A Paillier round's ciphertext bytes are the accounting model's at
    the key's own bit length (not the model's 2048-bit default)."""
    _, tidx, e, _ = world
    user = protocol.RemoteRagUser(n=DIM, N=N_DOCS, k=K, radius=0.05,
                                  backend="paillier", paillier_bits=256,
                                  rng=np.random.default_rng(3), device="cpu")
    cloud = protocol.RemoteRagCloud(tidx)
    _, _, tr = protocol.run_remoterag(user, cloud, e,
                                      torch.Generator().manual_seed(1))
    kb, kp = user.sk.pub.key_bits, user.plan.kprime
    assert tr.request_bytes - (DIM * 4 + 4) == acc.paillier_query_bytes(DIM,
                                                                        kb)
    assert tr.reply_bytes - kp * 4 == acc.paillier_scores_bytes(kp, kb)
