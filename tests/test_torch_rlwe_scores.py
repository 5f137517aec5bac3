"""Port RLWE scoring and decryption against the JAX package (the
setup is shared with test_torch_rlwe.py, split off to spread the JAX
compiles over test workers).

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


@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_cached_scores_bit_exact_and_equal_to_cold(setup, bsz):
    n_dim, docs, _, jcache, tcache, jcts, tcts = setup
    ids = np.random.default_rng(bsz).integers(0, NUM_DOCS, size=(bsz, KPRIME))
    want = jr.encrypted_scores_cached_batch(JP, jcts[:bsz], jcache, ids,
                                            use_pallas=False)
    got = tr.encrypted_scores_cached_batch(TP, tcts[:bsz], tcache, ids)
    np.testing.assert_array_equal(np.asarray(want.c0), got.c0.numpy())
    np.testing.assert_array_equal(np.asarray(want.c1), got.c1.numpy())
    packed = tr.pack_candidates_batch(TP, torch.from_numpy(docs[ids]))
    cold = tr.encrypted_scores_batch_stacked(TP, tcts[:bsz], packed, KPRIME,
                                             n_dim)
    assert torch.equal(cold.c0, got.c0) and torch.equal(cold.c1, got.c1)
    assert (cold.n_dim, cold.num_cands) == (got.n_dim, got.num_cands)


def test_fused_pallas_reference_matches_port(setup):
    """The JAX cached path through the fused Pallas kernel (interpret
    mode) gives the port's bits too."""
    _, _, _, jcache, tcache, jcts, tcts = setup
    ids = np.random.default_rng(99).integers(0, NUM_DOCS, size=(2, KPRIME))
    want = jr.encrypted_scores_cached_batch(JP, jcts[:2], jcache, ids,
                                            use_pallas=True)
    got = tr.encrypted_scores_cached_batch(TP, tcts[:2], tcache, ids)
    np.testing.assert_array_equal(np.asarray(want.c0), got.c0.numpy())
    np.testing.assert_array_equal(np.asarray(want.c1), got.c1.numpy())


def test_decrypt_matches_reference_and_plaintext(setup, keys):
    n_dim, docs, queries, jcache, tcache, jcts, tcts = setup
    jsk, tsk = keys
    ids = np.random.default_rng(5).integers(0, NUM_DOCS, size=(3, KPRIME))
    want = jr.decrypt_scores_batch(
        [jsk] * 3, jr.encrypted_scores_cached_batch(JP, jcts[:3], jcache, ids,
                                                    use_pallas=False))
    res = tr.encrypted_scores_cached_batch(TP, tcts[:3], tcache, ids)
    got = tr.decrypt_scores_batch([tsk] * 3, res)
    for b in range(3):
        np.testing.assert_array_equal(got[b], want[b])
        np.testing.assert_allclose(got[b], docs[ids[b]] @ queries[b], atol=2e-3)
        np.testing.assert_array_equal(tr.decrypt_scores(tsk, res.lane(b)),
                                      want[b])
    np.testing.assert_array_equal(
        tr.decrypt_rns(TP, tsk.s_ntt, tcts[0].c0, tcts[0].c1),
        jr.decrypt_rns(JP, jsk.s_ntt, jcts[0].c0, jcts[0].c1))
