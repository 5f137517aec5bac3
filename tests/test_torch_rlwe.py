"""Port RLWE (repro_torch.crypto.rlwe) against the JAX package.

Keys, query ciphertexts, the NTT-domain candidate cache and every score
ciphertext must match the reference bit for bit; the cached path must equal
the cold pack-then-score path.  Both packing strides are covered: n_dim = 32
(<= chunk, 2 candidates per ciphertext) and n_dim = 600 (> chunk, 2
chunks, 1 candidate per ciphertext) on the test ring N = 1024, chunk = 512.
"""

import numpy as np
import pytest
import torch

from repro.crypto import rlwe as jr
from repro_torch import convert
from repro_torch.crypto import rlwe as tr

JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)
NUM_DOCS = 40
KPRIME = 9          # not a multiple of cands_per_ct: the padding path


def _unit(rng, *shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def keys():
    return (jr.keygen(JP, np.random.default_rng(0)),
            tr.keygen(TP, np.random.default_rng(0), device="cpu"))


@pytest.fixture(scope="module", params=[32, 600])
def setup(request, keys):
    n_dim = request.param
    jsk, tsk = keys
    rng = np.random.default_rng(n_dim)
    docs = _unit(rng, NUM_DOCS, n_dim)
    queries = _unit(rng, 8, n_dim)
    jcache = jr.build_candidate_cache(JP, docs)
    tcache = tr.build_candidate_cache(TP, torch.from_numpy(docs))
    jcts = [jr.encrypt_query(jsk, q, np.random.default_rng(100 + i))
            for i, q in enumerate(queries)]
    tcts = [tr.encrypt_query(tsk, q, np.random.default_rng(100 + i))
            for i, q in enumerate(queries)]
    return n_dim, docs, queries, jcache, tcache, jcts, tcts


def test_params_match_reference():
    for jp, tp in ((JP, TP), (jr.RlweParams(), tr.RlweParams())):
        assert jp.primes == tp.primes and jp.big_q == tp.big_q
        assert jp.delta == tp.delta
        assert jr.params_key(jp) == tr.params_key(tp)
        for n_dim in (32, 600, 768, 3072):
            assert jp.stride(n_dim) == tp.stride(n_dim)
            assert jp.cands_per_ct(n_dim) == tp.cands_per_ct(n_dim)
            assert jp.num_chunks(n_dim) == tp.num_chunks(n_dim)
        assert jp.ciphertext_bytes() == tp.ciphertext_bytes()


def test_keygen_bit_exact(keys):
    jsk, tsk = keys
    np.testing.assert_array_equal(jsk.s, tsk.s)
    np.testing.assert_array_equal(np.asarray(jsk.s_ntt), tsk.s_ntt.numpy())


def test_encrypt_bit_exact(setup):
    *_, jcts, tcts = setup
    for j, t in zip(jcts, tcts):
        assert j.n_dim == t.n_dim
        np.testing.assert_array_equal(np.asarray(j.c0), t.c0.numpy())
        np.testing.assert_array_equal(np.asarray(j.c1), t.c1.numpy())


def test_cache_pool_bit_exact(setup):
    n_dim, _, _, jcache, tcache, _, _ = setup
    np.testing.assert_array_equal(np.asarray(jcache.polys), tcache.polys.numpy())
    np.testing.assert_array_equal(np.asarray(jcache.twiddles),
                                  tcache.twiddles.numpy())
    assert (tcache.stride, tcache.cands_per_ct, tcache.num_chunks) == (
        jcache.stride, jcache.cands_per_ct, jcache.num_chunks)
    assert tcache.nbytes == jcache.nbytes


def test_cache_twiddles_shoup_table(setup):
    """The caches carry the Shoup quotients floor(w * 2^32 / q) of their
    slot twiddles (the fused kernel's rotate), built once per cache on
    first use, and equal on every sharded or dense re-view."""
    _, docs, _, jcache, tcache, _, _ = setup
    tw = tcache.twiddles.numpy()
    got = tcache.twiddles_shoup
    assert got.dtype == torch.int32 and got.shape == tw.shape
    for p, q in enumerate(TP.primes):
        want = [[(int(w) << 32) // q for w in row] for row in tw[p]]
        assert got[p].numpy().view(np.uint32).tolist() == want
    sharded = tr.shard_candidate_cache(tcache, tr.CandidateCacheConfig(
        num_shards=2, async_admission=False))
    assert tcache.twiddles_shoup is got
    assert torch.equal(sharded.twiddles_shoup, got)
    assert torch.equal(tr.densify_candidate_cache(sharded).twiddles_shoup, got)
    conv = convert.candidate_cache(TP, np.asarray(jcache.polys),
                                   np.asarray(jcache.twiddles), docs.shape[1],
                                   device="cpu")
    assert torch.equal(conv.twiddles_shoup, got)


def test_single_query_paths(setup, keys):
    n_dim, docs, queries, _, tcache, _, tcts = setup
    _, tsk = keys
    ids = np.arange(KPRIME)
    cached = tr.encrypted_scores_cached(TP, tcts[0], tcache, ids)
    cold = tr.encrypted_scores(TP, tcts[0],
                               tr.pack_candidates(TP, torch.from_numpy(docs[ids])))
    assert torch.equal(cached.c0, cold.c0) and torch.equal(cached.c1, cold.c1)
    np.testing.assert_allclose(
        tr.cosine_distances(tr.decrypt_scores(tsk, cached)),
        1.0 - docs[ids] @ queries[0], atol=2e-3)


def test_convert_carries_reference_state(setup, keys):
    """Reference cache and key, carried over as numpy arrays, score and
    decrypt exactly as the port's own."""
    n_dim, _, _, jcache, tcache, jcts, tcts = setup
    jsk, tsk = keys
    cache = convert.candidate_cache(TP, np.asarray(jcache.polys),
                                    np.asarray(jcache.twiddles), n_dim,
                                    device="cpu")
    sk = convert.secret_key(TP, jsk.s, np.asarray(jsk.s_ntt), device="cpu")
    ids = np.arange(KPRIME)[None]
    a = tr.encrypted_scores_cached_batch(TP, tcts[:1], cache, ids)
    b = tr.encrypted_scores_cached_batch(TP, tcts[:1], tcache, ids)
    assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)
    np.testing.assert_array_equal(tr.decrypt_scores_batch([sk], a)[0],
                                  tr.decrypt_scores_batch([tsk], b)[0])


def test_cache_rejects_other_params(setup):
    n_dim, _, _, _, tcache, _, tcts = setup
    with pytest.raises(ValueError):
        tr.encrypted_scores_cached_batch(tr.RlweParams(), tcts[:1], tcache,
                                         np.zeros((1, 2), np.int64))


def test_default_ring_cached_scores_bit_exact():
    """The service ring (N = 4096, 3 primes, chunk 1024) at n_dim = 768:
    one chunk, 4 candidates per result ciphertext, as on the main path."""
    jp, tp = jr.RlweParams(), tr.RlweParams()
    rng = np.random.default_rng(11)
    docs, q = _unit(rng, 12, 768), _unit(rng, 768)
    jsk = jr.keygen(jp, np.random.default_rng(1))
    tsk = tr.keygen(tp, np.random.default_rng(1), device="cpu")
    jct = jr.encrypt_query(jsk, q, np.random.default_rng(2))
    tct = tr.encrypt_query(tsk, q, np.random.default_rng(2))
    ids = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5]])
    want = jr.encrypted_scores_cached_batch(
        jp, [jct], jr.build_candidate_cache(jp, docs), ids, use_pallas=False)
    got = tr.encrypted_scores_cached_batch(
        tp, [tct], tr.build_candidate_cache(tp, torch.from_numpy(docs)), ids)
    np.testing.assert_array_equal(np.asarray(want.c0), got.c0.numpy())
    np.testing.assert_array_equal(np.asarray(want.c1), got.c1.numpy())
    np.testing.assert_allclose(tr.decrypt_scores_batch([tsk], got)[0],
                               docs[ids[0]] @ q, atol=2e-3)
