"""Decryption down to the scores on the key's device (`decrypt_scores_batch`:
gather of the extraction coefficients, exact int64 CRT lift) against the
host path it replaces, `extract_scores` on `decrypt_rns`'s full d, bit for
bit.

Residues are uniform over [0, q_i) (the hardest input for the lift: x spans
all of [0, Q)), or chosen: 0 and q_i - 1 on every prime, and the x nearest
the centring threshold Q // 2, built by CRT.  The widths cover both strides
of the default ring (N = 4096, chunk 1024): 768 and 256 (4 candidates a
ciphertext) and 1,536 (2).  No JAX: the port's own host path is the
reference here; tests/test_torch_rlwe_scores.py holds that path to the JAX
package."""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.crypto import rlwe

P = rlwe.RlweParams()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain NTT's small ops crawl in torch's thread pool beside busy
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(27)
    return [rlwe.keygen(P, rng, device="cpu") for _ in range(3)]


def _uniform(rng, shape):
    """(..., P, N) int32 residues, uniform over [0, q_i) on prime i."""
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, size=shape + (P.n_poly,)) for q in P.primes],
        axis=-2).astype(np.int32))


def _host(sk, c0, c1, n_dim, num_cands):
    return rlwe.extract_scores(P, rlwe.decrypt_rns(P, sk.s_ntt, c0, c1),
                               n_dim, num_cands)


def _residues(values):
    """Integers in [0, Q) -> (len, P) int32 residues (CRT)."""
    return np.array([[v % q for q in P.primes] for v in values], np.int32)


# (n_dim, k'): k' past a multiple of cands_per_ct (4, 4, 2), so the last
# ciphertext is part-filled
@pytest.mark.parametrize("n_dim,kprime", [(768, 161), (256, 45),
                                          (1536, 99)])
def test_uniform_residues_equal_host_extraction(keys, n_dim, kprime):
    assert kprime % P.cands_per_ct(n_dim)
    num_ct = -(-kprime // P.cands_per_ct(n_dim))
    rng = np.random.default_rng(n_dim)
    c0, c1 = _uniform(rng, (3, num_ct)), _uniform(rng, (3, num_ct))
    got = rlwe.decrypt_scores_batch(keys, rlwe.ScoreCiphertextBatch(
        c0=c0, c1=c1, n_dim=n_dim, num_cands=kprime))
    assert len(got) == 3
    for b, sk in enumerate(keys):
        assert got[b].dtype == np.float64 and got[b].shape == (kprime,)
        np.testing.assert_array_equal(
            got[b], _host(sk, c0[b], c1[b], n_dim, kprime))


@pytest.mark.parametrize("case", ["zero", "q_minus_1", "half_q",
                                  "mixed_ends"])
def test_chosen_residues_equal_host_extraction(keys, case):
    """c1 = 0, so d = c0: each extraction coefficient takes the chosen
    residues, the rest stay uniform."""
    n_dim, kprime = 768, 8
    q = np.array(P.primes)
    half = P.big_q // 2
    chosen = {
        "zero": np.zeros((kprime, 3), np.int32),
        "q_minus_1": np.tile(q - 1, (kprime, 1)).astype(np.int32),
        # the centring threshold and its neighbours, and both ends
        "half_q": _residues([half, half + 1, half - 1, half + 2, 0,
                             P.big_q - 1, 1, P.big_q - 2]),
        # 0 and q_i - 1 mixed across the primes
        "mixed_ends": np.array([[0 if (c >> i) & 1 else q[i] - 1
                                 for i in range(3)] for c in range(kprime)],
                               np.int32),
    }[case]
    rng = np.random.default_rng(1)
    c0 = _uniform(rng, (1, 2))
    cpt, stride = P.cands_per_ct(n_dim), P.stride(n_dim)
    for c in range(kprime):
        c0[0, c // cpt, :, c % cpt * stride + P.chunk - 1] = torch.from_numpy(
            chosen[c])
    c1 = torch.zeros_like(c0)
    (got,) = rlwe.decrypt_scores_batch(keys[:1], rlwe.ScoreCiphertextBatch(
        c0=c0, c1=c1, n_dim=n_dim, num_cands=kprime))
    np.testing.assert_array_equal(got, _host(keys[0], c0[0], c1[0], n_dim,
                                             kprime))
    if case == "half_q":
        # x = Q // 2 and Q // 2 + 1 both decode to -t / 2
        assert got[0] == got[1] == -(P.t // 2) / (P.scale_q * P.scale_c)


@pytest.mark.parametrize("lanes", [
    [(768, 161), (768, 162), (768, 164)],        # one width, k' differs
    [(768, 164), (1536, 82), (256, 163)],        # strides differ too
])
def test_list_form_with_lanes_of_different_kprime(keys, lanes):
    """The list form: lanes share num_ct (41) but not k' or n_dim; each
    lane gets its own k' scores."""
    rng = np.random.default_rng(len(lanes) + lanes[1][0])
    cts = [rlwe.ScoreCiphertexts(c0=_uniform(rng, (41,)),
                                 c1=_uniform(rng, (41,)), n_dim=nd,
                                 num_cands=nc) for nd, nc in lanes]
    tracer = obs.Tracer()
    got = rlwe.decrypt_scores_batch(keys, cts, tracer=tracer)
    for sk, ct, g in zip(keys, cts, got):
        np.testing.assert_array_equal(
            g, _host(sk, ct.c0, ct.c1, ct.n_dim, ct.num_cands))
    spans = [s for s in tracer.spans() if s.name.startswith("decrypt_")]
    assert [s.name for s in spans] == ["decrypt_crt", "decrypt_wait",
                                       "decrypt_copy"]
    by = {s.name: s.attrs for s in spans}
    assert by["decrypt_crt"] == {"lanes": 3,
                                 "num_cands": sum(nc for _, nc in lanes)}
    # the scores only: lanes x widest k' x 8 bytes
    assert by["decrypt_copy"] == {"lanes": 3, "bytes": 3 * 164 * 8}


@pytest.mark.parametrize("n_dim,kprime", [(768, 5), (1536, 3)])
def test_single_lane_decrypt_scores_equals_host_extraction(keys, n_dim,
                                                           kprime):
    rng = np.random.default_rng(kprime)
    num_ct = -(-kprime // P.cands_per_ct(n_dim))
    res = rlwe.ScoreCiphertexts(c0=_uniform(rng, (num_ct,)),
                                c1=_uniform(rng, (num_ct,)), n_dim=n_dim,
                                num_cands=kprime)
    got = rlwe.decrypt_scores(keys[1], res)
    np.testing.assert_array_equal(
        got, _host(keys[1], res.c0, res.c1, n_dim, kprime))
    np.testing.assert_array_equal(
        got, rlwe.decrypt_scores_batch([keys[1]], [res])[0])


def test_round_trip_scores_equal_host_extraction(keys):
    """A real round at width 768 (encrypt, cached scoring of 13 candidates
    under two tenant keys): the device path equals the host's and the
    plaintext inner products to the fixed point's error."""
    rng = np.random.default_rng(3)
    docs = rng.normal(size=(40, 768))
    docs /= np.linalg.norm(docs, axis=1, keepdims=True)
    queries = docs[[3, 17]] + 0.1 * rng.normal(size=(2, 768))
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    cache = rlwe.build_candidate_cache(
        P, torch.from_numpy(docs.astype(np.float32)))
    qcts = [rlwe.encrypt_query(sk, q, np.random.default_rng(i))
            for i, (sk, q) in enumerate(zip(keys[:2], queries))]
    ids = rng.integers(0, 40, size=(2, 13))
    res = rlwe.encrypted_scores_cached_batch(P, qcts, cache, ids)
    got = rlwe.decrypt_scores_batch(keys[:2], res)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], _host(keys[b], res.c0[b], res.c1[b], 768, 13))
        np.testing.assert_allclose(got[b], docs[ids[b]] @ queries[b],
                                   atol=2e-3)
