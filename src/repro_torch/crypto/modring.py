"""Modular-arithmetic substrate for the RLWE path (PyTorch).

Host number theory (prime search, roots of unity, bit-reversed twiddle
tables) is the reference's, copied.  The device primitives work on int64
tensors: residues are canonical in [0, q) with q < 2^20, so a product is
below 2^40 and ``%`` gives the same bits as the reference's int32 limb
split (which existed only to fit TPU int32 lanes).  The CUDA kernels use a
64-bit Barrett reduction with ``barrett64 = floor(2^64 / q)`` (pointwise
product, the key product, the fused re-rank's Hadamard products and sums)
or Shoup products with a precomputed quotient ``floor(w * 2^32 / q)`` for
every constant ``w`` (the NTT's twiddles, the fused re-rank's slot
twiddles: `shoup_quotients`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side number theory (Python ints)
# ---------------------------------------------------------------------------


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (fixed witness set)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_primes(two_n: int, count: int, *, lo: int = 1 << 19, hi: int = 1 << 20):
    """Primes q in (lo, hi) with q = 1 mod two_n, largest first."""
    primes = []
    k = (hi - 1) // two_n
    while k * two_n + 1 > lo and len(primes) < count:
        q = k * two_n + 1
        if q < hi and is_prime(q):
            primes.append(q)
        k -= 1
    if len(primes) < count:
        raise ValueError(f"only {len(primes)} NTT primes = 1 mod {two_n} in range")
    return tuple(primes)


def primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    factors = []
    phi = q - 1
    m = phi
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no generator found")


def root_of_unity(q: int, order: int) -> int:
    """Element of exact multiplicative order ``order`` mod q."""
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) == q - 1
    return w


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# Per-prime constant bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class PrimeCtx:
    """Everything the NTT needs for one RNS prime.

    ``build`` is lru_cached, so each (q, n) pair maps to one instance; the
    instance memoizes its twiddle tables per device (`table`)."""

    q: int
    mu: int            # floor(2^30 / q), the reference's Barrett constant
    n: int             # transform size (polynomial degree)
    psi_table: np.ndarray      # (n,) int32 — bit-rev ordered powers of psi
    ipsi_table: np.ndarray     # (n,) int32 — bit-rev ordered powers of psi^-1
    n_inv: int         # N^{-1} mod q
    _tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def barrett64(self) -> int:
        """floor(2^64 / q): the CUDA kernels' Barrett constant."""
        return (1 << 64) // self.q

    def shoup(self, w: int) -> int:
        """floor(w * 2^32 / q): the Shoup quotient of a constant w in [0, q)."""
        return (int(w) << 32) // self.q

    @property
    def inv_tail(self) -> tuple:
        """Constants of the inverse NTT's last stage with N^{-1} folded in:
        (N^{-1}, its Shoup quotient, psi^{-1} * N^{-1} mod q, its quotient),
        where psi^{-1} = ipsi_table[1] is that stage's only twiddle."""
        w = int(self.ipsi_table[1]) * self.n_inv % self.q
        return self.n_inv, self.shoup(self.n_inv), w, self.shoup(w)

    @classmethod
    @functools.lru_cache(maxsize=None)
    def build(cls, q: int, n: int) -> "PrimeCtx":
        psi = root_of_unity(q, 2 * n)
        ipsi = pow(psi, -1, q)
        rev = bit_reverse_indices(n)
        psi_pows = np.array([pow(psi, int(i), q) for i in range(n)], dtype=np.int64)
        ipsi_pows = np.array([pow(ipsi, int(i), q) for i in range(n)], dtype=np.int64)
        return cls(
            q=q,
            mu=(1 << 30) // q,
            n=n,
            psi_table=psi_pows[rev].astype(np.int32),
            ipsi_table=ipsi_pows[rev].astype(np.int32),
            n_inv=pow(n, -1, q),
        )

    def table(self, kind: str, device: torch.device) -> torch.Tensor:
        """``kind`` in {"psi", "ipsi", "psi_shoup", "ipsi_shoup"}: the int32
        table on ``device``.  The ``*_shoup`` tables hold the Shoup quotient
        of each twiddle (`shoup`, computed with Python ints), a uint32 stored
        in the int32's bits."""
        key = (kind, str(device))
        t = self._tables.get(key)
        if t is None:
            base, _, shoup = kind.partition("_")
            src = self.psi_table if base == "psi" else self.ipsi_table
            if shoup:
                src = np.array([self.shoup(w) for w in src.tolist()],
                               dtype=np.uint32).view(np.int32)
            t = self._tables[key] = torch.from_numpy(src).to(device)
        return t


@dataclasses.dataclass(frozen=True, eq=False)
class RnsTables:
    """The NTT tables of several primes of one ring, stacked (P, N) int32 on
    one device (`PrimeCtx.table`'s, row p for prime p), the moduli as a
    (P, 1) int32 column for epilogues over all primes, and the per-prime
    scalars of the key-product kernel, flattened: (q, barrett64, N^-1 and
    the inverse's folded tail as `PrimeCtx.inv_tail`) for each prime."""

    psi: torch.Tensor
    psi_shoup: torch.Tensor
    ipsi: torch.Tensor
    ipsi_shoup: torch.Tensor
    q: torch.Tensor
    consts: tuple


_rns_tables: dict = {}


def rns_tables(ctxs, device: torch.device) -> RnsTables:
    """The stacked tables of ``ctxs`` on ``device``, built once per device
    (memoized like `PrimeCtx.table`)."""
    key = (tuple((c.q, c.n) for c in ctxs), str(device))
    t = _rns_tables.get(key)
    if t is None:
        stack = {kind: torch.stack([c.table(kind, device) for c in ctxs])
                 for kind in ("psi", "psi_shoup", "ipsi", "ipsi_shoup")}
        t = _rns_tables[key] = RnsTables(
            **stack,
            q=torch.tensor([[c.q] for c in ctxs], dtype=torch.int32,
                           device=device),
            consts=tuple(v for c in ctxs
                         for v in (c.q, c.barrett64, *c.inv_tail)))
    return t


# ---------------------------------------------------------------------------
# Device primitives on int64 tensors (canonical residues in [0, q))
# ---------------------------------------------------------------------------


def shoup_quotients(w: torch.Tensor, q) -> torch.Tensor:
    """floor(w * 2^32 / q) of every residue in ``w`` (int tensor in [0, q);
    ``q`` an int or a tensor broadcast against ``w``), as uint32 stored in
    int32 bits: the Shoup quotient table of a table of constants."""
    s = torch.div(w.to(torch.int64) << 32, q, rounding_mode="floor")
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def barrett_reduce(x: torch.Tensor, q: int, mu: int) -> torch.Tensor:
    """x mod q for 0 <= x < 2^31 — the reference's contract; on int64
    tensors the exact remainder gives the same bits."""
    return torch.remainder(x, q)


def mod_mul(a: torch.Tensor, b, q: int, mu: int = 0) -> torch.Tensor:
    """(a * b) mod q with a, b in [0, q), q < 2^20 (int64 product < 2^40)."""
    return torch.remainder(a.to(torch.int64) * b, q)


def mod_add(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    s = a + b
    return torch.where(s >= q, s - q, s)


def mod_sub(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def mod_sum(x: torch.Tensor, q: int, mu: int, axis: int) -> torch.Tensor:
    """Sum along ``axis`` then one reduction.  The reference accumulates in
    int32 and asserts the sum cannot wrap; the assert is kept so the port
    refuses exactly the shapes the reference refuses."""
    terms = x.shape[axis]
    assert terms * (q - 1) < 2**31, f"mod_sum overflow: {terms} terms at q={q}"
    return torch.remainder(x.to(torch.int64).sum(dim=axis), q)


# ---------------------------------------------------------------------------
# numpy int64 oracles (independent implementation for tests)
# ---------------------------------------------------------------------------


def mod_mul_np(a, b, q: int):
    return (a.astype(np.int64) * b.astype(np.int64)) % q


def negacyclic_mul_np(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Schoolbook negacyclic convolution in Z_q[X]/(X^n + 1) (int64 numpy)."""
    n = a.shape[-1]
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    full = np.zeros(a.shape[:-1] + (2 * n,), dtype=object)
    for i in range(n):
        full[..., i : i + n] += a[..., i : i + 1] * b
    lo = full[..., :n]
    hi = full[..., n:]
    return np.array((lo - hi) % q, dtype=np.int64)


__all__ = [
    "is_prime",
    "find_ntt_primes",
    "primitive_root",
    "root_of_unity",
    "bit_reverse_indices",
    "PrimeCtx",
    "RnsTables",
    "rns_tables",
    "shoup_quotients",
    "barrett_reduce",
    "mod_mul",
    "mod_add",
    "mod_sub",
    "mod_sum",
    "mod_mul_np",
    "negacyclic_mul_np",
]
