"""The stage roofline counts against bytes and operations worked out by
hand for both configurations' batches."""

import pytest

from rag_bench import counts

RLWE = dict(n_poly=4096, num_primes=3, chunk=1024)


@pytest.mark.parametrize("lanes,rows,dim,kprime,nbytes,ops", [
    # 10^6 x 768 float32 read once, 32 queries in, 161 (score, id) pairs
    # out per query; 2 ops per query, row and coordinate
    (32, 10**6, 768, 161, 3_072_000_000 + 98_304 + 41_216, 49_152_000_000),
    (8, 10**6, 256, 6795, 1_024_000_000 + 8_192 + 434_880, 4_096_000_000),
])
def test_topk_counts(lanes, rows, dim, kprime, nbytes, ops):
    assert counts.topk_counts(lanes, rows, dim, kprime) == (nbytes, ops)


@pytest.mark.parametrize("lanes,kprime,dim,nbytes,ops", [
    # a polynomial over 3 primes is 3 x 4096 x 4 = 49,152 bytes; 4
    # candidates a ciphertext at width <= 1024, so 41 results for 161;
    # per lane: 161 cache rows + 2 query + 2 x 41 result polynomials.
    # Per prime: 64 forward NTTs of 2048 x 12 butterflies x 3, 32 x 41
    # ciphertexts x 4096 x (4 rows x 5 + 2), 2 x 32 x 41 inverse NTTs
    # (+ 4096 scalings each)
    (32, 161, 768, 32 * 49_152 * 245,
     3 * (64 * 73_728 + 32 * 41 * 4096 * 22 + 2624 * 77_824)),
    # 6,795 candidates: 1,699 results a lane
    (8, 6795, 256, 8 * 49_152 * 10_195,
     3 * (16 * 73_728 + 8 * 1699 * 4096 * 22 + 27_184 * 77_824)),
])
def test_score_counts(lanes, kprime, dim, nbytes, ops):
    assert counts.score_counts(lanes, kprime, dim, **RLWE) == (nbytes, ops)


def test_bounds_name_their_term():
    t, by = counts.bound_s(*counts.topk_counts(32, 10**6, 768, 161),
                           counts.FP32_OPS_S)
    assert by == "bytes" and t == pytest.approx(3_072_139_520 / 3.35e12)
    t, by = counts.bound_s(0, 1.6727e13, counts.INT32_OPS_S)
    assert by == "operations" and t == pytest.approx(1.0, rel=1e-3)
