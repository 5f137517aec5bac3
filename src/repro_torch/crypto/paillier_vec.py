"""Vectorized Paillier (PyTorch): the object path's batch twin.

Counterpart of ``repro/crypto/paillier_vec.py``.  `crypto/paillier.py` is
the paper-faithful per-lane implementation: host Python bignums, one
modmul at a time.  This module computes the *same integers* — wire-byte
identical ciphertexts given the same rng, bit-exact decryptions — but
moves the modular arithmetic onto the RNS Montgomery tensor ops of
`repro_torch.kernels.bignum.ops`, on the caller's device (``cuda`` unless
the caller asks for ``cpu``), batched over every lane of a serve group at
once.  Division of labor per stage:

  encrypt    r^n for all dims of a query in one windowed exponentiation
             (blinding r drawn host-side in the object path's exact draw
             order, so ciphertext bytes match under a shared rng)
  score      per-(lane, dim) windowed power tables for the query
             ciphertexts and their inverses, then per window position one
             gathered [lanes, k', dims] multiply + a product tree over dims
             (candidate scalars are 15-bit fixed point, so 3 windows of 5
             bits cover them)
  decrypt    batched c^lambda, host L-function/mu finish

Query-ciphertext inverses (for negative fixed-point scalars) use
Montgomery's batch-inversion trick: one modular inverse plus 3 multiplies
per element.  The host/device boundary is crossed once per cohort each
way: `ref.to_rns` stacks a cohort's channel vectors on the host, and the
result comes back as one array for `ref.from_rns`.

Fallback: keys whose n^2 needs more residue channels than the budget
(`bignum.ref.MAX_CHANNELS`, e.g. 1024-bit keys) take the object path per
lane — the reference's policy on key size, not a device fallback;
`counters` records which path served each lane-call (guarded by a lock:
the replica router scores batches from several threads).  Lanes of
*different* key sizes within one batch are grouped by channel count and
each cohort runs as one batched call.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.crypto import paillier as pai
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.bignum import ops, ref

SCORE_WINDOW = 5    # 15-bit fixed-point scalars -> at most 3 window positions
EXP_WINDOW = 4      # dense (key-sized) exponents: n for blinding, lambda
# the gathered [lanes, chunk, dims, channels] block of one scoring step is
# kept below this many bytes (the reference chunked only for a CPU cache;
# any chunking gives the same integers)
SCORE_CHUNK_BYTES = 1 << 30

# Which path served each lane-call: tests and the fallback-boundary checks
# assert on these.  reset_counters() between measurements.
counters = {"vectorized": 0, "object": 0}
_counter_lock = threading.Lock()


def _count(path: str) -> None:
    with _counter_lock:
        counters[path] += 1


def reset_counters() -> None:
    with _counter_lock:
        counters["vectorized"] = 0
        counters["object"] = 0


def fits(pub: pai.PaillierPublicKey) -> bool:
    """True when this key's n^2 is inside the channel budget."""
    return ref.fits(pub.n_sq)


@functools.lru_cache(maxsize=64)
def _ctx(n_sq: int) -> ref.RnsModulus:
    return ref.for_modulus(n_sq)


def _draw_r(pub: pai.PaillierPublicKey,
            rng: Optional[np.random.Generator]) -> int:
    # Exact replica of paillier.encrypt's draw loop: consuming the same
    # rng stream in the same order is what makes wire bytes match.
    while True:
        r = pai._randbelow(pub.n, rng)
        if r and math.gcd(r, pub.n) == 1:
            return r


def _batch_modinv(values: Sequence[int], modulus: int) -> List[int]:
    """Montgomery batch inversion: one extended-gcd + 3 muls per element."""
    prefix = [1]
    for v in values:
        prefix.append(prefix[-1] * v % modulus)
    inv = pow(prefix[-1], -1, modulus)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % modulus
        inv = inv * values[i] % modulus
    return out


def _consts(ctxs: Sequence[ref.RnsModulus], batch_ndim: int,
            device: torch.device) -> dict:
    return ops.make_consts(ctxs[0].system, list(ctxs), batch_ndim,
                           device=device)


def _to_rns_mont(ctxs: Sequence[ref.RnsModulus],
                 rows: Sequence[Sequence[int]],
                 device: torch.device) -> torch.Tensor:
    """Per-lane int rows -> stacked Montgomery-form channel tensor
    [lanes, len(row), channels] on ``device`` (one host-to-device copy)."""
    out = [ref.to_rns(c, [v * c.system.M % c.modulus for v in row])
           for c, row in zip(ctxs, rows)]
    return torch.from_numpy(np.stack(out)).to(device)


def _lane_digits(exponents: Sequence[int], count: int,
                 device: torch.device) -> torch.Tensor:
    """Each lane's exponent digits repeated over ``count`` values:
    [lanes, count, positions] int64 on ``device``."""
    dig = torch.from_numpy(ops.to_digits(exponents, EXP_WINDOW)).to(device)
    return dig[:, None, :].expand(-1, count, -1)


def _exp(base: torch.Tensor, digits: torch.Tensor, C: dict,
         window: int) -> torch.Tensor:
    """base^digits, demontgomerized."""
    table = ops.pow_table(base, C, window)
    acc = ops.mont_exp_digits(table, digits, C, window)
    return ops.mont_mul(acc, C["plain_one"], C)


def _score(q, qinv, digits, signs, rbase, rdigits, C2, C3) -> torch.Tensor:
    """One serve group's encrypted re-rank.

    q/qinv: [L, D, C] Montgomery query cts (+inverses); digits: [L, K, D, P]
    window digits of |k| (most-significant first); signs: [L, K, D] int64
    (1 = negative scalar -> inverse table); rbase: [L, K, C] Montgomery
    blinding bases; rdigits: [L, K, Pn] digits of each lane's n.
    Returns demontgomerized [L, K, C] score ciphertext channels.
    Candidates go through in chunks that keep the gathered block below
    `SCORE_CHUNK_BYTES`.
    """
    table = torch.cat([ops.pow_table(q, C2, SCORE_WINDOW),
                       ops.pow_table(qinv, C2, SCORE_WINDOW)], 0)
    nlanes, kprime, ndim = digits.shape[:3]
    nch = table.shape[-1]
    chunk = max(1, min(kprime, SCORE_CHUNK_BYTES // (nlanes * ndim * nch * 8)))
    dev = q.device
    lane = torch.arange(nlanes, device=dev)[:, None, None]
    dim = torch.arange(ndim, device=dev)[None, None, :]
    accs = []
    for c0 in range(0, kprime, chunk):
        dig, sgn = digits[:, c0:c0 + chunk], signs[:, c0:c0 + chunk]
        acc = C2["one"].expand(nlanes, dig.shape[1], nch)
        for p in range(dig.shape[-1]):
            acc = ops.square_n(acc, C2, SCORE_WINDOW)
            idx = dig[..., p] + sgn * (1 << SCORE_WINDOW)     # [L, c, D]
            g = table[idx, lane, dim]                         # [L, c, D, C]
            acc = ops.mont_mul(acc, ops.product_reduce(g, C3), C2)
        accs.append(acc)
    acc = torch.cat(accs, dim=1)
    blind = ops.mont_exp_digits(ops.pow_table(rbase, C2, EXP_WINDOW),
                                rdigits, C2, EXP_WINDOW)
    return ops.mont_mul(ops.mont_mul(acc, blind, C2), C2["plain_one"], C2)


def _from_channels(ctx: ref.RnsModulus, arr: np.ndarray) -> List[int]:
    return [v % ctx.modulus for v in ref.from_rns(ctx, arr)]


def encrypt_vector(pub: pai.PaillierPublicKey, e: np.ndarray,
                   rng: Optional[np.random.Generator] = None, *,
                   device: DeviceLike = None) -> list:
    """Drop-in for `paillier.encrypt_vector`: same bytes, batched r^n on
    ``device``."""
    e = np.asarray(e, np.float64)
    if not fits(pub) or len(e) == 0:
        _count("object")
        return pai.encrypt_vector(pub, e, rng)
    _count("vectorized")
    dev = resolve_device(device)
    ms = pai.encode_vector(e, pub.n)
    rs = [_draw_r(pub, rng) for _ in ms]
    ctx = _ctx(pub.n_sq)
    rn = _exp(_to_rns_mont([ctx], [rs], dev),
              _lane_digits([pub.n], len(ms), dev),
              _consts([ctx], 2, dev), EXP_WINDOW).cpu().numpy()
    return [(1 + m * pub.n) % pub.n_sq * x % pub.n_sq
            for m, x in zip(ms, _from_channels(ctx, rn[0]))]


def encrypted_scores_batch(
        pubs: Sequence[pai.PaillierPublicKey],
        enc_queries: Sequence[Sequence[int]],
        cands: Sequence,
        rngs: Optional[Sequence[Optional[np.random.Generator]]] = None, *,
        device: DeviceLike = None,
) -> List[list]:
    """Batched `paillier.encrypted_scores` across lanes, on ``device``.

    ``cands[i]`` is lane i's [k', dims] candidate block (a numpy array or a
    tensor; same shape across lanes — the serve group contract).  ``rngs``
    supplies per-lane blinding randomness in the object path's draw order;
    None draws from `secrets`.  Oversized keys fall back per lane.  Returns
    per-lane ciphertext lists.
    """
    nlanes = len(pubs)
    if rngs is None:
        rngs = [None] * nlanes
    out: List[Optional[list]] = [None] * nlanes

    # Blinding must be drawn lane-by-lane in candidate order *before* any
    # cohort regrouping, to consume each lane's stream exactly as the
    # object path would.
    cohorts: dict = {}
    for i, pub in enumerate(pubs):
        kprime = cands[i].shape[0]
        if not fits(pub):
            _count("object")
            rows = cands[i]
            if isinstance(rows, torch.Tensor):
                rows = rows.cpu().numpy()
            out[i] = pai.encrypted_scores(pub, enc_queries[i], rows,
                                          rng=rngs[i])
            continue
        _count("vectorized")
        rs = [_draw_r(pub, rngs[i]) for _ in range(kprime)]
        cohorts.setdefault(ref.num_channels(pub.n_sq), []).append((i, rs))
    if not cohorts:
        return out

    dev = resolve_device(device)
    for members in cohorts.values():
        lanes = [i for i, _ in members]
        ctxs = [_ctx(pubs[i].n_sq) for i in lanes]
        # [L, k', dims] float64 on the device (float32 rows widen exactly;
        # round() is half-to-even, as the object path's np.rint)
        blk = torch.stack([torch.as_tensor(cands[i]).to(dev, torch.float64)
                           for i in lanes])
        ks = torch.round(blk * (1 << pai.FRAC_BITS)).long()
        signs = (ks < 0).long()
        kabs = ks.abs()
        npos = max(1, -(-int(kabs.max()).bit_length() // SCORE_WINDOW))
        shifts = SCORE_WINDOW * torch.arange(npos - 1, -1, -1, device=dev)
        digits = (kabs[..., None] >> shifts) & ((1 << SCORE_WINDOW) - 1)
        qs = [list(enc_queries[i]) for i in lanes]
        qinvs = [_batch_modinv(row, ctx.modulus)
                 for row, ctx in zip(qs, ctxs)]
        res = _score(
            _to_rns_mont(ctxs, qs, dev), _to_rns_mont(ctxs, qinvs, dev),
            digits, signs, _to_rns_mont(ctxs, [rs for _, rs in members], dev),
            _lane_digits([pubs[i].n for i in lanes], ks.shape[1], dev),
            _consts(ctxs, 2, dev), _consts(ctxs, 3, dev)).cpu().numpy()
        for j, i in enumerate(lanes):
            out[i] = _from_channels(ctxs[j], res[j])
    return out


def decrypt_scores_batch(sks: Sequence[pai.PaillierSecretKey],
                         enc_lists: Sequence[Sequence[int]], *,
                         device: DeviceLike = None) -> List[np.ndarray]:
    """Batched `paillier.decrypt_scores`: c^lambda in one batched call per
    cohort on ``device``, L-function + centered fixed-point decode on the
    host (bit-exact)."""
    nlanes = len(sks)
    out: List[Optional[np.ndarray]] = [None] * nlanes
    cohorts: dict = {}
    for i, sk in enumerate(sks):
        if not fits(sk.pub) or len(enc_lists[i]) == 0:
            _count("object")
            out[i] = pai.decrypt_scores(sk, enc_lists[i])
            continue
        _count("vectorized")
        cohorts.setdefault(ref.num_channels(sk.pub.n_sq), []).append(i)
    if not cohorts:
        return out

    dev = resolve_device(device)
    for lanes in cohorts.values():
        ctxs = [_ctx(sks[i].pub.n_sq) for i in lanes]
        kprime = len(enc_lists[lanes[0]])
        res = _exp(_to_rns_mont(ctxs, [enc_lists[i] for i in lanes], dev),
                   _lane_digits([sks[i].lam for i in lanes], kprime, dev),
                   _consts(ctxs, 2, dev), EXP_WINDOW).cpu().numpy()
        for j, i in enumerate(lanes):
            sk = sks[i]
            xs = _from_channels(ctxs[j], res[j])
            ms = [(x - 1) // sk.pub.n * sk.mu % sk.pub.n for x in xs]
            out[i] = np.asarray(
                [pai._decode(m, sk.pub.n, 2 * pai.FRAC_BITS) for m in ms],
                np.float64)
    return out


__all__ = ["fits", "encrypt_vector", "encrypted_scores_batch",
           "decrypt_scores_batch", "counters", "reset_counters",
           "SCORE_WINDOW", "EXP_WINDOW", "SCORE_CHUNK_BYTES"]
