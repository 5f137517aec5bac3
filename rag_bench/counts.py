"""The yardstick of the stage rooflines: the H100's published peaks and
the bytes and operations each stage's work needs, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the operations are those the algorithm
needs.  A stage's least time is ``max(bytes / HBM_BYTES_S, ops / peak)``
and its roofline share is that over the stage's device time.  The peaks
and the NTT operation counts are those of ``chip_smoke.py``."""

from __future__ import annotations

import math
from typing import Tuple

HBM_BYTES_S = 3.35e12             # H100 SXM HBM3
FP32_OPS_S = 67e12                # float32 outside the tensor cores
INT32_OPS_S = 132 * 64 * 1.98e9   # 132 SMs x 64 int32 lanes x 1.98 GHz


def bound_s(nbytes: float, ops: float, ops_rate: float) -> Tuple[float, str]:
    """(least seconds, the term that bounds it: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def topk_counts(lanes: int, rows: int, dim: int,
                kprime: int) -> Tuple[int, int]:
    """First stage for ``lanes`` queries: the corpus rows scanned and the
    queries in (float32), k' float32 scores and int32 ids out per lane;
    one multiply and one add per (query, row, coordinate)."""
    nbytes = 4 * rows * dim + 4 * lanes * dim + lanes * kprime * (4 + 4)
    ops = 2 * lanes * rows * dim
    return nbytes, ops


def ntt_ops(polys: int, n_poly: int, *, inverse: bool) -> int:
    """A radix-2 NTT network: (N/2) log2 N butterflies of 3 operations,
    and the inverse's N^-1 scaling."""
    return polys * ((n_poly // 2) * int(math.log2(n_poly)) * 3
                    + (n_poly if inverse else 0))


def score_counts(lanes: int, kprime: int, dim: int, *, n_poly: int,
                 num_primes: int, chunk: int) -> Tuple[int, int]:
    """Cached encrypted scoring for ``lanes`` queries, every prime: the
    gathered cache rows (k' x chunks x P x N int32 a lane) and the query
    ciphertexts' two components in, the result ciphertexts' two
    components out; per prime the queries' forward NTTs, the rotate /
    Hadamard / mod-sum over a ciphertext's rows (5 operations a row and
    coefficient, 2 to finish) and the results' inverse NTTs."""
    chunks = -(-dim // chunk)
    stride = chunk if dim <= chunk else 2 * chunk
    cpt = n_poly // stride
    num_ct = -(-kprime // cpt)
    rows = cpt * chunks
    poly = num_primes * n_poly * 4
    nbytes = lanes * (kprime * chunks * poly + 2 * chunks * poly
                      + 2 * num_ct * poly)
    per_prime = (ntt_ops(2 * lanes * chunks, n_poly, inverse=False)
                 + lanes * num_ct * n_poly * (rows * 5 + 2)
                 + ntt_ops(2 * lanes * num_ct, n_poly, inverse=True))
    return nbytes, num_primes * per_prime
