"""Paper-faithful Paillier PHE (paper Section 3.3.1), the object path.

Counterpart of ``repro/crypto/paillier.py``, copied: host Python integers
plus numpy, the same draw order from a ``numpy.random.Generator`` (so keys
and ciphertexts are bit-identical under shared seeds) and `secrets` when no
generator is given.  The batched twin on the device is
`repro_torch.crypto.paillier_vec`.

The paper's Module 2(a) encrypts the query embedding with a partially
homomorphic scheme and has the cloud evaluate cosine distances in encrypted
form: ct+ct addition and ct*plaintext scalar multiplication.  Paillier is the
canonical choice and serves two roles here:

  1. fidelity baseline — the protocol path the paper actually measured
     (its 0.67 s / 2.72 h numbers are Paillier-bound);
  2. cost model — bignum modexp per value is host work, so this module
     is plain Python; the device-native path is `crypto/rlwe.py`.

Fixed-point encoding: values v are encoded as round(v * 2^frac_bits) mod n,
with negatives in the upper half of Z_n (centered lift at decode).
"""

from __future__ import annotations

import dataclasses
import math
import secrets
from typing import Sequence

import numpy as np

from repro_torch.crypto.modring import is_prime


def _randbits(bits: int, rng: np.random.Generator | None = None) -> int:
    """`secrets`-backed by default; an np.random.Generator makes key and
    encryption randomness *deterministic* — for reproducible benchmarking /
    replay parity only, not for real deployments."""
    if rng is None:
        return secrets.randbits(bits)
    nbytes = (bits + 7) // 8
    return int.from_bytes(rng.bytes(nbytes), "big") >> (nbytes * 8 - bits)


def _randbelow(n: int, rng: np.random.Generator | None = None) -> int:
    if rng is None:
        return secrets.randbelow(n)
    bits = n.bit_length()
    while True:
        r = _randbits(bits, rng)
        if r < n:
            return r


def _rand_prime(bits: int, rng: np.random.Generator | None = None) -> int:
    while True:
        cand = _randbits(bits, rng) | (1 << (bits - 1)) | 1
        if is_prime(cand):
            return cand


@dataclasses.dataclass(frozen=True)
class PaillierPublicKey:
    n: int
    n_sq: int
    g: int  # fixed to n + 1

    @property
    def key_bits(self) -> int:
        return self.n.bit_length()

    def ciphertext_bytes(self) -> int:
        return (2 * self.key_bits + 7) // 8


@dataclasses.dataclass(frozen=True)
class PaillierSecretKey:
    pub: PaillierPublicKey
    lam: int   # lcm(p-1, q-1)
    mu: int    # (L(g^lam mod n^2))^{-1} mod n


def keygen(bits: int = 1024,
           rng: np.random.Generator | None = None) -> PaillierSecretKey:
    """Generate a Paillier keypair with an n of ~`bits` bits."""
    while True:
        p = _rand_prime(bits // 2, rng)
        q = _rand_prime(bits // 2, rng)
        if p != q:
            break
    n = p * q
    pub = PaillierPublicKey(n=n, n_sq=n * n, g=n + 1)
    lam = math.lcm(p - 1, q - 1)
    x = pow(pub.g, lam, pub.n_sq)
    l_x = (x - 1) // n
    mu = pow(l_x, -1, n)
    return PaillierSecretKey(pub=pub, lam=lam, mu=mu)


def encrypt(pub: PaillierPublicKey, m: int,
            rng: np.random.Generator | None = None) -> int:
    """Enc(m) = (1 + mn) * r^n mod n^2  (g = n+1 shortcut)."""
    m %= pub.n
    while True:
        r = _randbelow(pub.n, rng)
        if r and math.gcd(r, pub.n) == 1:
            break
    return (1 + m * pub.n) % pub.n_sq * pow(r, pub.n, pub.n_sq) % pub.n_sq


def decrypt(sk: PaillierSecretKey, c: int) -> int:
    x = pow(c, sk.lam, sk.pub.n_sq)
    return (x - 1) // sk.pub.n * sk.mu % sk.pub.n


def add(pub: PaillierPublicKey, c1: int, c2: int) -> int:
    """Enc(m1 + m2)."""
    return c1 * c2 % pub.n_sq


def mul_plain(pub: PaillierPublicKey, c: int, k: int) -> int:
    """Enc(m * k) for plaintext scalar k (signed).

    Negative k uses the ciphertext inverse so the exponent stays |k|-sized;
    the naive ``k % n`` lift would turn a 13-bit fixed-point scalar into a
    ~keysize-bit exponent (~500x slower modexp).
    """
    if k < 0:
        c = pow(c, -1, pub.n_sq)
        k = -k
    return pow(c, k, pub.n_sq)


# ---------------------------------------------------------------------------
# fixed-point vector layer (what the protocol uses)
# ---------------------------------------------------------------------------

FRAC_BITS = 13  # matches the RLWE scales for apples-to-apples accuracy


def _encode(v: float, n: int, frac_bits: int = FRAC_BITS) -> int:
    return round(float(v) * (1 << frac_bits)) % n


def encode_vector(e: np.ndarray, n: int,
                  frac_bits: int = FRAC_BITS) -> list[int]:
    """Batched `_encode`: one vectorized scale+round over the whole vector
    instead of a per-component python loop.  Bit-identical — both paths
    compute ``v * 2^frac_bits`` in float64 and round half-even (python
    ``round`` on a float and ``np.rint`` share the IEEE tie rule), and the
    final ``% n`` runs in exact integer arithmetic either way."""
    scaled = np.rint(np.asarray(e, np.float64) * (1 << frac_bits))
    return [int(m) % n for m in scaled.astype(np.int64)]


def _decode(m: int, n: int, frac_bits: int) -> float:
    if m > n // 2:
        m -= n
    return m / (1 << frac_bits)


def encrypt_vector(pub: PaillierPublicKey, e: np.ndarray,
                   rng: np.random.Generator | None = None) -> list:
    """[[e_k]]: componentwise encryption of the query embedding."""
    return [encrypt(pub, _encode(v, pub.n), rng)
            for v in np.asarray(e, np.float64)]


def encrypted_dot(pub: PaillierPublicKey, enc_query: Sequence[int],
                  cand: np.ndarray, enc_query_inv=None) -> int:
    """[[<e_k, cand>]] = prod_j [[e_j]]^{cand_j}  (ct*plain + ct+ct only).

    ``enc_query_inv``: optional precomputed ciphertext inverses so negative
    fixed-point scalars cost a small-exponent pow instead of a modinv per
    (dim x candidate) — see encrypted_scores.
    """
    acc = encrypt(pub, 0)
    for j, (c_j, v) in enumerate(zip(enc_query, np.asarray(cand, np.float64))):
        k = round(float(v) * (1 << FRAC_BITS))
        if not k:
            continue
        if k < 0 and enc_query_inv is not None:
            acc = acc * pow(enc_query_inv[j], -k, pub.n_sq) % pub.n_sq
        else:
            acc = add(pub, acc, mul_plain(pub, c_j, k))
    return acc


def encrypted_scores(pub: PaillierPublicKey, enc_query: Sequence[int],
                     cands: np.ndarray,
                     rng: np.random.Generator | None = None) -> list:
    """Encrypted inner products against each of the k' candidates.

    Fixed-base optimization: each query ciphertext is the base for k'
    exponentiations by small signed scalars, so we precompute its (and its
    inverse's) bit powers c^(2^i) once per request; each candidate dim then
    costs only popcount(k) modmuls — no per-candidate squarings.

    ``rng`` seeds the per-candidate blinding (the fresh encryption of zero);
    the default draws from `secrets`.  A seeded generator exists so the
    vectorized twin (`paillier_vec`) can be checked for wire-byte parity —
    blinding cancels at decryption either way.
    """
    n_sq = pub.n_sq
    bits = FRAC_BITS + 2
    pows, ipows = [], []
    for c in enc_query:
        ci = pow(c, -1, n_sq)
        row, irow = [c], [ci]
        for _ in range(bits - 1):
            row.append(row[-1] * row[-1] % n_sq)
            irow.append(irow[-1] * irow[-1] % n_sq)
        pows.append(row)
        ipows.append(irow)

    out = []
    for cand in np.asarray(cands, np.float64):
        acc = encrypt(pub, 0, rng)
        ks = np.rint(cand * (1 << FRAC_BITS)).astype(np.int64)
        for j, k in enumerate(ks):
            if not k:
                continue
            row = pows[j] if k > 0 else ipows[j]
            k = int(abs(k))
            i = 0
            while k:
                if k & 1:
                    acc = acc * row[i] % n_sq
                k >>= 1
                i += 1
        out.append(acc)
    return out


def decrypt_scores(sk: PaillierSecretKey, enc_scores: Sequence[int]) -> np.ndarray:
    out = [_decode(decrypt(sk, c), sk.pub.n, 2 * FRAC_BITS) for c in enc_scores]
    return np.asarray(out, np.float64)


__all__ = [
    "PaillierPublicKey", "PaillierSecretKey", "keygen", "encrypt", "decrypt",
    "add", "mul_plain", "encrypt_vector", "encode_vector", "encrypted_dot",
    "encrypted_scores", "decrypt_scores", "FRAC_BITS",
]
