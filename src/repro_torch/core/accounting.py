"""Communication cost model (paper Table 2 + Section 4.2).

Counterpart of ``repro/core/accounting.py``, copied (pure Python).

Units: one number = beta units, one document = eta units.  We provide both
the paper's symbolic formulas (validated against measured message sizes in
tests) and concrete byte counts for each crypto backend.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CommCost:
    rounds: float
    numbers: int        # beta units
    documents: int      # eta units

    def bytes_total(self, beta: int = 4, eta: int = 1024) -> int:
        return self.numbers * beta + self.documents * eta


def privacy_ignorant(n: int, k: int) -> CommCost:
    """Plaintext embedding up, k documents down."""
    return CommCost(rounds=1.0, numbers=n, documents=k)


def privacy_conscious(n: int, big_n: int) -> CommCost:
    """Modules 2(a)+2(c) with k' = N: PHE over all N + OT over all N."""
    return CommCost(rounds=2.0, numbers=n + 2 * big_n + 1, documents=big_n)


def remoterag_direct(n: int, k: int, kprime: int) -> CommCost:
    """Modules 1 + 2(a) + 2(b): 2.5 rounds, (2n + k + k' + 1)b + k*eta."""
    return CommCost(rounds=2.5, numbers=2 * n + k + kprime + 1, documents=k)


def remoterag_ot(n: int, kprime: int) -> CommCost:
    """Modules 1 + 2(a) + 2(c): 3 rounds, 2(n + k' + 1)b + k'*eta."""
    return CommCost(rounds=3.0, numbers=2 * (n + kprime + 1), documents=kprime)


def optimized_rounds(cost: CommCost) -> CommCost:
    """Section 4.2 'practical optimization': piggyback module-1 + 2(a) and the
    distance reply + OT start — 2 rounds for either path."""
    return dataclasses.replace(cost, rounds=2.0)


# ---------------------------------------------------------------------------
# concrete wire-size models per crypto backend
# ---------------------------------------------------------------------------

def paillier_query_bytes(n: int, key_bits: int = 2048) -> int:
    """n ciphertexts of 2*key_bits each."""
    return n * 2 * key_bits // 8


def paillier_scores_bytes(kprime: int, key_bits: int = 2048) -> int:
    return kprime * 2 * key_bits // 8


def rlwe_query_bytes(n: int, *, n_poly: int = 4096, num_primes: int = 3,
                     chunk: int = 1024, coeff_bits: int = 20) -> int:
    chunks = -(-n // chunk)
    return chunks * 2 * num_primes * n_poly * coeff_bits // 8


def rlwe_scores_bytes(kprime: int, n: int, *, n_poly: int = 4096,
                      num_primes: int = 3, chunk: int = 1024,
                      coeff_bits: int = 20) -> int:
    stride = chunk if n <= chunk else 2 * chunk
    cands_per_ct = n_poly // stride
    num_ct = -(-kprime // cands_per_ct)
    return num_ct * 2 * num_primes * n_poly * coeff_bits // 8


__all__ = [
    "CommCost", "privacy_ignorant", "privacy_conscious", "remoterag_direct",
    "remoterag_ot", "optimized_rounds", "paillier_query_bytes",
    "paillier_scores_bytes", "rlwe_query_bytes", "rlwe_scores_bytes",
]
