"""Residue-number-system (RNS) bignum arithmetic: reference half (numpy).

Counterpart of ``repro/kernels/bignum/ref.py``, copied: the plain version
of `repro_torch.kernels.bignum.ops` and the tests' oracle.

The vectorized Paillier backend (`repro_torch.crypto.paillier_vec`) needs modular
multiplication and exponentiation over ~512-2048-bit moduli, batched over
thousands of independent values, on hardware whose SIMD units know nothing
about bignums.  Schoolbook limb arithmetic vectorizes badly: the
carry/reduction graph is thousands of tiny elementwise ops.  The classic
answer is to represent each value by its residues modulo many machine-word
primes:

  * channel products are independent (no carries): one elementwise
    multiply across a ``[batch, channels]`` array;
  * the only cross-channel work is Montgomery reduction's two *base
    extensions*, and each is a matrix product against a fixed integer
    matrix — a GEMM.

Layout.  A value is a float64 vector of ``2s + 1`` residue channels:
``s`` primes forming base M (the Montgomery modulus), ``s`` primes forming
the auxiliary base M', and one redundant power-of-two channel m_r = 2^23
used by the exact (Shenoy–Kumaresan) second base extension.  Channels are
23-bit integers stored in float64 lanes — products stay below 2^46 and GEMM
accumulations below 2^53, so every operation is *exact* in doubles while
vectorizing at full SIMD width.  Batched ciphertext blocks are shaped
``[batch, k', channels]``.

Algorithm (Bajard–Imbert RNS Montgomery with an exact second extension):
values live in Montgomery form v·M mod N and in the *incomplete reduction*
domain [0, (s+1)·N).  One multiply is

  1. channel product        x = a·b                (elementwise, all channels)
  2. xi_i = x_i·c1_i mod m_i with c1 = -N^{-1}·(M/m_i)^{-1}   (base M)
  3. q-hat = sum xi_i·(M/m_i): residues on M' + m_r via GEMM against E1
  4. w = (x + q-hat·N)/M on M' + m_r  (elementwise, folded constants)
  5. extend w back to base M exactly: Shenoy–Kumaresan via the m_r channel
     (alpha = number of M' overflows, recovered exactly because alpha <= s
     < m_r), GEMM against E2

The first extension is allowed to overshoot by alpha·M (Bajard's trick): it
only shifts w by multiples of N, which the incomplete-reduction domain
absorbs; the headroom bits in M keep the domain closed under multiplication.

This module is the pure-NumPy mirror of the tensor ops in ``ops.py`` —
same formulas, same constants, differential-tested against Python ``pow``
in tests/test_torch_bignum.py.  Keep the two in lockstep.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np


CH_BITS = 23                    # channel width: products < 2^46 exact in f64
RADIX = 1 << CH_BITS            # the redundant S-K modulus m_r (power of two)
HEADROOM_BITS = 20              # M >= 2^HEADROOM * modulus: closes the
                                # incomplete-reduction domain under multiply
# Policy budget: moduli needing more channels than this fall back to the
# object-path bignum implementation (compile size + GEMM width stay bounded).
# The exactness ceiling is 128 channels (sum of 2^46 products in f64); the
# policy budget sits well under it.  1024-bit Paillier keys (2048-bit n^2,
# 90 channels) are the first fallback tier.
MAX_CHANNELS = 64
HARD_CHANNELS = 128


def _is_small_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, valid far beyond 2^23 channel range."""
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


@functools.lru_cache(maxsize=None)
def _channel_primes(count: int) -> tuple:
    """The ``count`` largest primes below 2^23, descending (deterministic,
    shared by every modulus of a given channel count)."""
    out: List[int] = []
    c = RADIX - 1
    while len(out) < count:
        if _is_small_prime(c):
            out.append(c)
        c -= 2
    return tuple(out)


def num_channels(modulus: int) -> int:
    """Channels per base for ``modulus`` (bit length + headroom, 23/channel)."""
    return -(-(modulus.bit_length() + HEADROOM_BITS) // CH_BITS)


def fits(modulus: int, budget: int | None = None) -> bool:
    """True when ``modulus`` is inside the compiled channel budget."""
    limit = MAX_CHANNELS if budget is None else budget
    return num_channels(modulus) <= min(limit, HARD_CHANNELS)


@dataclasses.dataclass(frozen=True)
class RnsSystem:
    """Modulus-independent channel system: the primes and the two base-
    extension matrices.  One instance per channel count ``s``, shared by
    every key of that size class (so multi-tenant batches whose lanes hold
    different keys of one size compile exactly once)."""
    s: int
    m: tuple                    # base M primes
    mp: tuple                   # base M' primes
    M: int
    Mp: int
    Mi: tuple                   # M / m_i
    Mpi: tuple                  # M' / mp_j
    E1: np.ndarray              # [s, s+1]: (M/m_i) mod t,  t in mp + (m_r,)
    E2: np.ndarray              # [s, s+1]: (M'/mp_j) mod t, t in m + (m_r,)
    Minv_t: np.ndarray          # [s+1]: M^{-1} mod t, t in mp + (m_r,)
    c4: np.ndarray              # [s]: (M'/mp_j)^{-1} mod mp_j
    Mp_mod_m: np.ndarray        # [s]: M' mod m_i
    Mpinv_r: float              # M'^{-1} mod m_r
    mv: np.ndarray              # [s] base M primes, f64
    mpv: np.ndarray             # [s] base M' primes, f64
    tgt: np.ndarray             # [s+1] = mp + (m_r,), f64
    allm: np.ndarray            # [2s+1] all channel moduli, f64
    pow2: np.ndarray            # [s, 2s+1]: 2^(23*l) mod channel (to_rns GEMM)
    crt_inv: tuple              # [s]: (M/m_i)^{-1} mod m_i (from_rns weights)


@functools.lru_cache(maxsize=None)
def get_system(s: int) -> RnsSystem:
    if s > HARD_CHANNELS:
        raise ValueError(
            f"{s} channels exceeds the f64-exactness ceiling {HARD_CHANNELS}")
    ps = _channel_primes(2 * s)
    m, mp = ps[:s], ps[s:]
    M = 1
    for p in m:
        M *= p
    Mp = 1
    for p in mp:
        Mp *= p
    Mi = tuple(M // p for p in m)
    Mpi = tuple(Mp // p for p in mp)
    tgt = list(mp) + [RADIX]
    allm = list(m) + list(mp) + [RADIX]
    return RnsSystem(
        s=s, m=m, mp=mp, M=M, Mp=Mp, Mi=Mi, Mpi=Mpi,
        E1=np.array([[mi % t for t in tgt] for mi in Mi], np.float64),
        E2=np.array([[mpi % t for t in list(m) + [RADIX]] for mpi in Mpi],
                    np.float64),
        Minv_t=np.array([pow(M, -1, t) for t in tgt], np.float64),
        c4=np.array([pow(Mpi[j], -1, p) for j, p in enumerate(mp)],
                    np.float64),
        Mp_mod_m=np.array([Mp % p for p in m], np.float64),
        Mpinv_r=float(pow(Mp, -1, RADIX)),
        mv=np.array(m, np.float64),
        mpv=np.array(mp, np.float64),
        tgt=np.array(tgt, np.float64),
        allm=np.array(allm, np.float64),
        pow2=np.array([[pow(2, CH_BITS * l, t) for t in allm]
                       for l in range(s)], np.float64),
        crt_inv=tuple(pow(Mi[i], -1, p) for i, p in enumerate(m)),
    )


@dataclasses.dataclass(frozen=True)
class RnsModulus:
    """Per-modulus constants on top of a shared `RnsSystem`."""
    system: RnsSystem
    modulus: int
    c1: np.ndarray              # [s]: (-N^{-1}·(M/m_i)^{-1}) mod m_i
    NMinv_t: np.ndarray         # [s+1]: (N·M^{-1}) mod t, t in mp + (m_r,)
    one: np.ndarray             # [2s+1]: to_rns(M mod N) — Montgomery one
    plain_one: np.ndarray       # [2s+1]: to_rns(1) — demontgomerize partner


def for_modulus(modulus: int) -> RnsModulus:
    """Build the per-modulus channel constants (host side, cached by the
    caller per key)."""
    sysm = get_system(num_channels(modulus))
    c1 = np.array([(-pow(modulus, -1, p) * pow(sysm.Mi[i], -1, p)) % p
                   for i, p in enumerate(sysm.m)], np.float64)
    NMinv_t = np.array(
        [modulus % t * pow(sysm.M, -1, t) % t
         for t in (list(sysm.mp) + [RADIX])], np.float64)
    ctx = RnsModulus(system=sysm, modulus=modulus, c1=c1, NMinv_t=NMinv_t,
                     one=np.empty(0), plain_one=np.empty(0))
    one = to_rns(ctx, [sysm.M % modulus])[0]
    plain_one = to_rns(ctx, [1])[0]
    object.__setattr__(ctx, "one", one)
    object.__setattr__(ctx, "plain_one", plain_one)
    return ctx


# ---------------------------------------------------------------------------
# host conversions
# ---------------------------------------------------------------------------

def to_mont(ctx: RnsModulus, x: int) -> int:
    """Canonical int -> Montgomery form (host bignum, exact)."""
    return x * ctx.system.M % ctx.modulus


def from_mont(ctx: RnsModulus, x: int) -> int:
    return x * pow(ctx.system.M, -1, ctx.modulus) % ctx.modulus


def to_rns(ctx: RnsModulus, values: Sequence[int]) -> np.ndarray:
    """Batch-decompose ints (< M) into channel vectors, [len(values), 2s+1].

    One ``to_bytes`` per value, then a vectorized bit-regroup into 23-bit
    limbs and a GEMM against the fixed 2^(23l) power table — exact in f64
    (limbs and table entries < 2^23, accumulation < s·2^46 <= 2^52)."""
    sysm = ctx.system
    s = sysm.s
    nbits = s * CH_BITS
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(
        b"".join(int(v).to_bytes(nbytes, "little") for v in values),
        np.uint8).reshape(len(values), nbytes)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :nbits]
    limbs = bits.reshape(len(values), s, CH_BITS).astype(np.float64)
    limbs = limbs @ (2.0 ** np.arange(CH_BITS))
    return _mod(limbs @ sysm.pow2, sysm.allm)


def from_rns(ctx: RnsModulus, vec: np.ndarray) -> List[int]:
    """Channel vectors [..., 2s+1] -> exact ints via CRT over base M.

    Valid for any value < M — in particular the whole incomplete-reduction
    domain [0, (s+1)·N).  Callers reduce mod N themselves."""
    sysm = ctx.system
    flat = np.asarray(vec, np.float64).reshape(-1, vec.shape[-1])
    # small CRT coefficients vectorized (residue * inv mod p is < 2^46,
    # exact in f64); only the weighted bignum sum runs per value
    coef = _mod(flat[:, :sysm.s] * np.array(sysm.crt_inv, np.float64),
                sysm.mv).astype(np.int64)
    out = []
    for row in coef:
        x = 0
        for i in range(sysm.s):
            x += int(row[i]) * sysm.Mi[i]
        out.append(x % sysm.M)
    return out


# ---------------------------------------------------------------------------
# reference arithmetic (NumPy mirror of ops.py — keep formulas in lockstep)
# ---------------------------------------------------------------------------

def _mod(t: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Exact floor-division modular reduction for |t| < 2^52.

    The reciprocal is rounded, so the quotient can be off by one either
    way: two conditional corrections pin the residue into [0, m)."""
    q = np.floor(t * (1.0 / m))
    r = t - q * m
    r = r + m * (r < 0)
    return r - m * (r >= m)


def mont_mul(ctx: RnsModulus, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One RNS Montgomery multiply: mont(x), mont(y) -> mont(x·y), both
    sides and the result in the incomplete domain [0, (s+1)·N)."""
    sysm = ctx.system
    s = sysm.s
    x = _mod(a * b, sysm.allm)
    xi = _mod(x[..., :s] * ctx.c1, sysm.mv)
    u = _mod(xi @ sysm.E1, sysm.tgt)
    wt = _mod(x[..., s:] * sysm.Minv_t + u * ctx.NMinv_t, sysm.tgt)
    xip = _mod(wt[..., :s] * sysm.c4, sysm.mpv)
    g2 = xip @ sysm.E2
    alpha = _mod((_mod(g2[..., s:], float(RADIX)) - wt[..., s:])
                 * sysm.Mpinv_r, float(RADIX))
    wm = _mod(g2[..., :s] - alpha * sysm.Mp_mod_m, sysm.mv)
    return np.concatenate([wm, wt], axis=-1)


def mont_exp(ctx: RnsModulus, base: np.ndarray, exponent: int) -> np.ndarray:
    """Square-and-multiply reference exponentiation (host loop)."""
    acc = np.broadcast_to(ctx.one, base.shape).copy()
    for bit in bin(exponent)[2:]:
        acc = mont_mul(ctx, acc, acc)
        if bit == "1":
            acc = mont_mul(ctx, acc, base)
    return acc


def modmul(ctx: RnsModulus, x: int, y: int) -> int:
    """End-to-end scalar check helper: x·y mod N through the RNS path."""
    a = to_rns(ctx, [to_mont(ctx, x % ctx.modulus)])
    b = to_rns(ctx, [to_mont(ctx, y % ctx.modulus)])
    out = mont_mul(ctx, mont_mul(ctx, a, b)[0], ctx.plain_one)
    return from_rns(ctx, out)[0] % ctx.modulus


__all__ = [
    "CH_BITS", "RADIX", "HEADROOM_BITS", "MAX_CHANNELS", "HARD_CHANNELS",
    "RnsSystem", "RnsModulus", "get_system", "for_modulus", "num_channels",
    "fits", "to_mont", "from_mont", "to_rns", "from_rns", "mont_mul",
    "mont_exp", "modmul",
]
