"""RNS-RLWE additively homomorphic encryption ("BFV-lite"), PyTorch.

Counterpart of ``repro/crypto/rlwe.py`` for the dense-cache and cold
paths (the sharded cache waits for a later slice).  Scheme, packing and
correctness budget are the reference's; see its module docstring.

  ring      R_q = Z_q[X]/(X^N + 1),  q = q_0 q_1 q_2  (RNS, ~20-bit NTT primes)
  enc(m)    c0 = a*s + e + Delta*m,  c1 = a;   a ~ U(R_q), e ~ CBD(eta)
  ct (x) p  (c0*p, c1*p) for a plaintext p; candidates packed reversed

Host randomness is the reference's: keygen and encryption draw from a
``numpy.random.Generator`` in the same order, so keys and ciphertexts are
bit-identical to the JAX package's.  Everything else runs on the device of
the key (user side) or of the candidate cache (cloud side) through
`repro_torch.kernels.ntt.ops`, which launches the CUDA kernels on CUDA
tensors.  The bignum CRT lift of decryption stays on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.crypto import modring
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ntt import ops as ntt_ops


@dataclasses.dataclass(frozen=True, eq=False)
class RlweParams:
    n_poly: int = 4096          # ring dimension N
    num_primes: int = 3         # RNS primes (~20 bits each)
    t_bits: int = 28            # plaintext modulus t = 2^t_bits
    scale_q_bits: int = 13      # query fixed-point scale  Delta_q = 2^13
    scale_c_bits: int = 13      # candidate fixed-point scale Delta_c = 2^13
    eta: int = 8                # CBD noise parameter, |e| <= eta
    chunk: int = 1024           # dot-product chunk size (<= n_poly)

    def __post_init__(self):
        assert self.n_poly % self.chunk == 0
        self.validate()

    @functools.cached_property
    def primes(self) -> tuple:
        return modring.find_ntt_primes(2 * self.n_poly, self.num_primes)

    @functools.cached_property
    def ctxs(self) -> tuple:
        return tuple(PrimeCtx.build(q, self.n_poly) for q in self.primes)

    @functools.cached_property
    def big_q(self) -> int:
        return math.prod(self.primes)

    @property
    def t(self) -> int:
        return 1 << self.t_bits

    @functools.cached_property
    def delta(self) -> int:
        return self.big_q // self.t

    @property
    def scale_q(self) -> int:
        return 1 << self.scale_q_bits

    @property
    def scale_c(self) -> int:
        return 1 << self.scale_c_bits

    def stride(self, n_dim: int) -> int:
        """Block stride: extraction at o_b + chunk - 1 must clear the previous
        block's span o_b + chunk - 1 + (chunk_used - 1)."""
        return self.chunk if n_dim <= self.chunk else 2 * self.chunk

    def cands_per_ct(self, n_dim: int) -> int:
        return self.n_poly // self.stride(n_dim)

    def num_chunks(self, n_dim: int) -> int:
        return -(-n_dim // self.chunk)

    def validate(self) -> None:
        assert (1 << (self.scale_q_bits + self.scale_c_bits)) * 1.1 < self.t / 2, \
            "plaintext scales overflow t"
        worst = (self.eta * (self.n_poly // self.chunk) * self.scale_c
                 * math.isqrt(self.chunk) * 4)
        assert 2 * self.t * worst < self.big_q, "noise budget exceeded"

    def ciphertext_bytes(self, packed_bits: int = 20) -> int:
        """Wire size of one ciphertext (2 components, RNS, bit-packed)."""
        return 2 * self.num_primes * self.n_poly * packed_bits // 8


@dataclasses.dataclass(frozen=True, eq=False)
class RlweSecretKey:
    params: RlweParams
    s: np.ndarray          # (N,) int8 ternary
    s_ntt: torch.Tensor    # (P, N) int32 — NTT(s) per prime, on the device


@dataclasses.dataclass(frozen=True, eq=False)
class QueryCiphertext:
    """Encrypted, chunked query embedding: (chunks, P, N) int32 per component."""
    c0: torch.Tensor
    c1: torch.Tensor
    n_dim: int


@dataclasses.dataclass(frozen=True, eq=False)
class PackedCandidates:
    """NTT-domain packed candidate plaintexts: polys (num_ct, chunks, P, N)."""
    polys: torch.Tensor
    n_dim: int
    num_cands: int


@dataclasses.dataclass(frozen=True, eq=False)
class ScoreCiphertexts:
    """Encrypted inner products: (num_ct, P, N) int32 per component."""
    c0: torch.Tensor
    c1: torch.Tensor
    n_dim: int
    num_cands: int


@dataclasses.dataclass(frozen=True, eq=False)
class ScoreCiphertextBatch:
    """B stacked score ciphertexts: (B, num_ct, P, N) int32 per component."""
    c0: torch.Tensor
    c1: torch.Tensor
    n_dim: int
    num_cands: int

    @property
    def batch(self) -> int:
        return self.c0.shape[0]

    def lane(self, b: int) -> ScoreCiphertexts:
        return ScoreCiphertexts(c0=self.c0[b], c1=self.c1[b],
                                n_dim=self.n_dim, num_cands=self.num_cands)

    def lanes(self) -> list:
        return [self.lane(b) for b in range(self.batch)]


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _to_rns(values: np.ndarray, params: RlweParams) -> np.ndarray:
    """Signed int64 (..., N) -> RNS int32 (P, ..., N)."""
    out = [np.mod(values, q).astype(np.int32) for q in params.primes]
    return np.stack(out, axis=0)


def _cbd(rng: np.random.Generator, eta: int, n: int) -> np.ndarray:
    a = rng.integers(0, 2, size=(eta, n)).sum(axis=0)
    b = rng.integers(0, 2, size=(eta, n)).sum(axis=0)
    return (a - b).astype(np.int64)


def _fixed_point(e: np.ndarray, scale: int) -> np.ndarray:
    return np.rint(np.asarray(e, np.float64) * scale).astype(np.int64)


def _fixed_point_t(e: torch.Tensor, scale: int) -> torch.Tensor:
    """`_fixed_point` on a device tensor: float64 product (exact for a
    power-of-two scale) rounded half to even, as ``np.rint``."""
    return torch.round(e.to(torch.float64) * scale).to(torch.int64)


def _ntt_per_prime(rns: np.ndarray, params: RlweParams,
                   device: torch.device) -> torch.Tensor:
    """(P, ..., N) host residues -> (P, ..., N) NTT domain on ``device``."""
    return torch.stack([
        ntt_ops.ntt_fwd(torch.from_numpy(np.ascontiguousarray(rns[i])).to(device),
                        ctx)
        for i, ctx in enumerate(params.ctxs)])


def keygen(params: RlweParams, rng: np.random.Generator, *,
           device: DeviceLike = None) -> RlweSecretKey:
    dev = resolve_device(device)
    s = rng.integers(-1, 2, size=(params.n_poly,)).astype(np.int8)
    s_ntt = _ntt_per_prime(_to_rns(s.astype(np.int64), params), params, dev)
    return RlweSecretKey(params=params, s=s, s_ntt=s_ntt)


# ---------------------------------------------------------------------------
# user side: encrypt / decrypt
# ---------------------------------------------------------------------------

def encrypt_query(sk: RlweSecretKey, e: np.ndarray,
                  rng: np.random.Generator) -> QueryCiphertext:
    """Encrypt a unit-norm query embedding of any dimension (chunked), on
    the key's device.  The host draws (per chunk: the noise, then one
    uniform ``a`` per prime) keep the reference's order."""
    p = sk.params
    dev = sk.s_ntt.device
    n_dim = e.shape[-1]
    chunks = p.num_chunks(n_dim)
    ints = _fixed_point(e, p.scale_q)
    m = np.zeros((chunks, p.n_poly), np.int64)
    err = np.zeros((chunks, p.n_poly), np.int64)
    a = np.zeros((p.num_primes, chunks, p.n_poly), np.int32)
    for c in range(chunks):
        seg = ints[c * p.chunk:(c + 1) * p.chunk]
        m[c, : len(seg)] = seg
        # signed (centered) encoding: Delta*m mod q per RNS prime (see the
        # reference for why an unsigned mod-t lift would break plain-mult)
        err[c] = _cbd(rng, p.eta, p.n_poly)
        for i, ctx in enumerate(p.ctxs):
            a[i, c] = rng.integers(0, ctx.q, size=(p.n_poly,)).astype(np.int32)
    err_t = torch.from_numpy(err).to(dev)
    c0s, c1s = [], []
    for i, ctx in enumerate(p.ctxs):
        a_i = torch.from_numpy(a[i]).to(dev)
        dm = torch.from_numpy((int(p.delta % ctx.q) * np.mod(m, ctx.q)) % ctx.q
                              ).to(dev)
        s_i = sk.s_ntt[i].expand(chunks, p.n_poly)
        a_s = ntt_ops.ntt_inv(
            ntt_ops.pointwise_mul(ntt_ops.ntt_fwd(a_i, ctx), s_i, ctx), ctx)
        c0s.append(torch.remainder(a_s.to(torch.int64) + err_t + dm, ctx.q)
                   .to(torch.int32))
        c1s.append(a_i)
    return QueryCiphertext(c0=torch.stack(c0s, dim=1),
                           c1=torch.stack(c1s, dim=1), n_dim=n_dim)


def decrypt_rns(params: RlweParams, s_ntt: torch.Tensor, c0: torch.Tensor,
                c1: torch.Tensor) -> np.ndarray:
    """RNS phase of decryption: d = c0 - c1*s per prime, on the device.

    ``c0``/``c1`` are (..., P, N); ``s_ntt`` broadcasts against the leading
    dims of NTT(c1) — (P, N) for one key or (B, 1, P, N) for per-tenant
    keys.  Returns host int64 (..., P, N)."""
    d_p = []
    for i, ctx in enumerate(params.ctxs):
        f1 = ntt_ops.ntt_fwd(c1[..., i, :], ctx)
        sb = s_ntt[..., i, :].expand(f1.shape)
        c1s = ntt_ops.ntt_inv(ntt_ops.pointwise_mul(f1, sb, ctx), ctx)
        d_p.append(modring.mod_sub(c0[..., i, :], c1s, ctx.q))
    return torch.stack(d_p, dim=-2).cpu().numpy().astype(np.int64)


def extract_scores(params: RlweParams, d_rns: np.ndarray, n_dim: int,
                   num_cands: int) -> np.ndarray:
    """CRT-reconstruct the extraction coefficients of d_rns (num_ct, P, N)
    (Python bignums) -> float scores (num_cands,)."""
    p = params
    stride = p.stride(n_dim)
    cpt = p.cands_per_ct(n_dim)
    g = [p.big_q // q for q in p.primes]
    h = [pow(gi % qi, -1, qi) for gi, qi in zip(g, p.primes)]
    scale = float(p.scale_q * p.scale_c)
    out = np.zeros(num_cands, np.float64)
    for cand in range(num_cands):
        ct_i, slot = divmod(cand, cpt)
        coeff = slot * stride + p.chunk - 1
        big = 0
        for i, qi in enumerate(p.primes):
            big += int(d_rns[ct_i, i, coeff]) * g[i] * h[i]
        big %= p.big_q
        if big > p.big_q // 2:
            big -= p.big_q
        val = round(big * p.t / p.big_q)  # noise removal
        val = ((val + p.t // 2) % p.t) - p.t // 2
        out[cand] = val / scale
    return out


def decrypt_scores(sk: RlweSecretKey, res: ScoreCiphertexts) -> np.ndarray:
    """Decrypt packed inner products -> float scores (len num_cands)."""
    d_rns = decrypt_rns(sk.params, sk.s_ntt, res.c0, res.c1)
    return extract_scores(sk.params, d_rns, res.n_dim, res.num_cands)


def decrypt_scores_batch(sks: Sequence[RlweSecretKey], cts) -> list:
    """Decrypt B score ciphertexts under B (distinct) tenant keys with one
    NTT launch per prime and kernel; CRT extraction stays per lane (host
    bignums).  ``cts`` is a list of ScoreCiphertexts or a
    ScoreCiphertextBatch."""
    params = sks[0].params
    if isinstance(cts, ScoreCiphertextBatch):
        c0, c1 = cts.c0, cts.c1
        meta = [(cts.n_dim, cts.num_cands)] * cts.batch
    else:
        c0 = torch.stack([c.c0 for c in cts])
        c1 = torch.stack([c.c1 for c in cts])
        meta = [(c.n_dim, c.num_cands) for c in cts]
    s_ntt = torch.stack([sk.s_ntt for sk in sks])[:, None]  # (B, 1, P, N)
    d_rns = decrypt_rns(params, s_ntt, c0, c1)
    return [extract_scores(params, d_rns[b], nd, nc)
            for b, (nd, nc) in enumerate(meta)]


# ---------------------------------------------------------------------------
# cloud side: dense NTT-domain candidate cache (build once, serve many)
# ---------------------------------------------------------------------------

def params_key(params: RlweParams) -> tuple:
    """Value identity of an RlweParams (primes derive from n_poly+num_primes)."""
    return (params.n_poly, params.num_primes, params.t_bits,
            params.scale_q_bits, params.scale_c_bits, params.eta, params.chunk)


@dataclasses.dataclass(frozen=True, eq=False)
class CandidateCache:
    """Per-document NTT-domain plaintexts, packed once at index-build time.

    ``polys[d, c]`` holds document d's chunk c reverse-packed at slot 0 and
    forward-NTT'd per prime: (num_docs, chunks, P, N) int32 on the index's
    device.  Slot s of a result ciphertext is a pointwise multiply by
    ``twiddles[:, s]``, the NTT-domain diagonal of X^{s*stride} — bit
    identical to fresh packing (see the reference's CandidateCache)."""
    params: RlweParams
    polys: torch.Tensor            # (num_docs, chunks, P, N) int32, NTT domain
    twiddles: torch.Tensor         # (P, cands_per_ct, N) int32, NTT(X^{s*stride})
    n_dim: int
    num_docs: int
    stride: int
    cands_per_ct: int
    num_chunks: int

    @property
    def nbytes(self) -> int:
        return self.polys.numel() * 4

    def check_compatible(self, params: RlweParams, n_dim=None) -> None:
        _check_cache_compatible(self, params, n_dim)


def _cache_geometry(params: RlweParams, n_dim: int) -> tuple:
    """(chunks, stride, cands_per_ct) with the 32-bit accumulator check the
    fused kernel relies on (cpt*chunks raw terms in [0, q) per sum)."""
    chunks = params.num_chunks(n_dim)
    stride = params.stride(n_dim)
    cpt = params.cands_per_ct(n_dim)
    assert cpt * chunks * (params.primes[0] - 1) < 2**31, \
        "cpt*chunks too large for the int32 accumulator"
    return chunks, stride, cpt


def _check_cache_compatible(cache, params: RlweParams, n_dim=None) -> None:
    if params_key(params) != params_key(cache.params):
        raise ValueError(
            f"candidate cache was built for RlweParams "
            f"{params_key(cache.params)} but scoring uses "
            f"{params_key(params)}; rebuild the cache for these params")
    if n_dim is not None and n_dim != cache.n_dim:
        raise ValueError(
            f"candidate cache packs n_dim={cache.n_dim} but the query "
            f"has n_dim={n_dim}")


def _pack_corpus_ntt(params: RlweParams, emb: torch.Tensor) -> torch.Tensor:
    """The corpus half of negacyclic packing: every document's chunks
    reverse-packed at slot 0 and forward-NTT'd per prime, (num_docs,
    chunks, P, N) int32 on ``emb``'s device.

    The reference packs the whole corpus on the host and copies it over;
    at 10^6 documents the pool is ~49 GB, so here the same arithmetic
    (fixed point, reversed placement, mod q, forward NTT) runs in document
    blocks on the device, each block written into the preallocated pool."""
    num_docs, n_dim = emb.shape
    chunks, _, _ = _cache_geometry(params, n_dim)
    pool = torch.empty((num_docs, chunks, params.num_primes, params.n_poly),
                       dtype=torch.int32, device=emb.device)
    block = max(1, (1 << 24) // (chunks * params.n_poly))
    for lo in range(0, num_docs, block):
        ints = _fixed_point_t(emb[lo:lo + block], params.scale_c)  # (b, n_dim)
        polys = torch.zeros((ints.shape[0], chunks, params.n_poly),
                            dtype=torch.int64, device=emb.device)
        for c in range(chunks):
            seg = ints[:, c * params.chunk:(c + 1) * params.chunk]
            # p[chunk - 1 - j] = seg[j]
            polys[:, c, params.chunk - seg.shape[1]:params.chunk] = seg.flip(-1)
        for i, ctx in enumerate(params.ctxs):
            pool[lo:lo + ints.shape[0], :, i] = ntt_ops.ntt_fwd(
                torch.remainder(polys, ctx.q).to(torch.int32), ctx)
    return pool


def _slot_twiddles(params: RlweParams, n_dim: int,
                   device: torch.device) -> torch.Tensor:
    """NTT-domain diagonals of the slot monomials X^{s*stride}: (P, cpt, N)."""
    _, stride, cpt = _cache_geometry(params, n_dim)
    mono = np.zeros((cpt, params.n_poly), np.int64)
    mono[np.arange(cpt), np.arange(cpt) * stride] = 1
    return _ntt_per_prime(_to_rns(mono, params), params, device)


def build_candidate_cache(params: RlweParams,
                          embeddings: torch.Tensor) -> CandidateCache:
    """Precompute the NTT-domain plaintexts of every document (slot 0) plus
    the per-slot monomial twiddles, on the embeddings' device."""
    num_docs, n_dim = embeddings.shape
    chunks, stride, cpt = _cache_geometry(params, n_dim)
    return CandidateCache(params=params,
                          polys=_pack_corpus_ntt(params, embeddings),
                          twiddles=_slot_twiddles(params, n_dim,
                                                  embeddings.device),
                          n_dim=n_dim, num_docs=num_docs, stride=stride,
                          cands_per_ct=cpt, num_chunks=chunks)


def _ids_tensor(ids, device: torch.device) -> torch.Tensor:
    """Candidate ids (numpy, list or tensor) as int64 on ``device``."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(np.asarray(ids))
    return ids.to(device=device, dtype=torch.int64)


def _scores_pipeline(c0, c1, g, twiddles, ctxs, cpt: int, pad: int):
    """Zero padding for the last result ciphertext's empty slots, then per
    prime the query forward NTTs and the fused rotate -> Hadamard ->
    slot/chunk mod-sum -> inverse NTT.  ``g`` is (B, nc, chunks, P, N)."""
    bsz = g.shape[0]
    chunks, n = c0.shape[1], c0.shape[-1]
    if pad:
        g = torch.cat([g, torch.zeros((bsz, pad) + tuple(g.shape[2:]),
                                      dtype=g.dtype, device=g.device)], dim=1)
    num_ct = g.shape[1] // cpt
    outs0, outs1 = [], []
    for i, ctx in enumerate(ctxs):
        f0 = ntt_ops.ntt_fwd(c0[:, :, i, :], ctx)
        f1 = ntt_ops.ntt_fwd(c1[:, :, i, :], ctx)
        polys_i = g[..., i, :].reshape(bsz, num_ct, cpt * chunks, n)
        acc0, acc1 = ntt_ops.fused_rotate_hadamard_intt(
            polys_i, twiddles[i], f0, f1, ctx)
        outs0.append(acc0)
        outs1.append(acc1)
    return torch.stack(outs0, dim=2), torch.stack(outs1, dim=2)


def encrypted_scores_cached_batch(params: RlweParams,
                                  q_cts: Sequence[QueryCiphertext],
                                  cache: CandidateCache,
                                  cand_ids) -> ScoreCiphertextBatch:
    """Batched ct (x) p against cached NTT-domain candidates: one gather of
    k' cached rows per lane, then per prime 2 query forward NTTs and one
    fused rotate -> Hadamard -> mod-sum -> inverse-NTT launch.  Bit
    identical to `pack_candidates_batch` + `encrypted_scores_batch_stacked`."""
    ids = _ids_tensor(cand_ids, cache.polys.device)
    assert ids.dim() == 2, "cand_ids must be (B, num_cands)"
    bsz, num_cands = ids.shape
    assert len(q_cts) == bsz
    cache.check_compatible(params, q_cts[0].n_dim)
    cpt = cache.cands_per_ct
    pad = -(-num_cands // cpt) * cpt - num_cands
    c0 = torch.stack([q.c0 for q in q_cts])                # (B, chunks, P, N)
    c1 = torch.stack([q.c1 for q in q_cts])
    g = cache.polys.index_select(0, ids.reshape(-1)).reshape(
        (bsz, num_cands) + tuple(cache.polys.shape[1:]))  # (B, nc, chunks, P, N)
    all0, all1 = _scores_pipeline(c0, c1, g, cache.twiddles, params.ctxs,
                                  cpt, pad)
    return ScoreCiphertextBatch(c0=all0, c1=all1, n_dim=cache.n_dim,
                                num_cands=num_cands)


def encrypted_scores_cached(params: RlweParams, q_ct: QueryCiphertext,
                            cache: CandidateCache, cand_ids) -> ScoreCiphertexts:
    """Cached ct (x) p for one query (the B=1 slice of the batch version)."""
    return encrypted_scores_cached_batch(
        params, [q_ct], cache, _ids_tensor(cand_ids, cache.polys.device)[None]
    ).lane(0)


# ---------------------------------------------------------------------------
# cloud side, cold path: pack candidates per request (the cache's oracle)
# ---------------------------------------------------------------------------

def pack_candidates_batch(params: RlweParams, cands, *,
                          device: DeviceLike = None) -> torch.Tensor:
    """Pack (B, num_cands, n_dim) candidate rows -> (B, num_ct, chunks, P, N)
    NTT-domain plaintexts (p[o + chunk-1 - j] = seg[j] at slot offset o).
    A tensor is packed on its own device; anything else goes to
    ``device``."""
    if not isinstance(cands, torch.Tensor):
        cands = torch.as_tensor(np.asarray(cands), device=resolve_device(device))
    bsz, num_cands, n_dim = cands.shape
    chunks = params.num_chunks(n_dim)
    stride = params.stride(n_dim)
    cpt = params.cands_per_ct(n_dim)
    num_ct = -(-num_cands // cpt)
    ints = _fixed_point_t(cands, params.scale_c)           # (B, nc, n_dim)
    ints = torch.cat([ints, torch.zeros(
        (bsz, num_ct * cpt - num_cands, n_dim), dtype=torch.int64,
        device=ints.device)], dim=1).reshape(bsz, num_ct, cpt, n_dim)
    polys = torch.zeros((bsz, num_ct, chunks, params.n_poly),
                        dtype=torch.int64, device=ints.device)
    for slot in range(cpt):
        end = slot * stride + params.chunk
        for c in range(chunks):
            seg = ints[:, :, slot, c * params.chunk:(c + 1) * params.chunk]
            polys[:, :, c, end - seg.shape[-1]:end] = seg.flip(-1)
    return torch.stack([
        ntt_ops.ntt_fwd(torch.remainder(polys, ctx.q).to(torch.int32), ctx)
        for ctx in params.ctxs], dim=3)                    # (B, num_ct, chunks, P, N)


def pack_candidates(params: RlweParams, cands, *,
                    device: DeviceLike = None) -> PackedCandidates:
    """Pack candidate embeddings (num_cands, n_dim) into NTT-domain
    plaintexts (the B=1 slice of the batch packer)."""
    num_cands, n_dim = cands.shape
    polys = pack_candidates_batch(params, cands[None], device=device)[0]
    return PackedCandidates(polys=polys, n_dim=n_dim, num_cands=num_cands)


def encrypted_scores_batch_stacked(params: RlweParams,
                                   q_cts: Sequence[QueryCiphertext],
                                   packed: torch.Tensor, num_cands: int,
                                   n_dim: int) -> ScoreCiphertextBatch:
    """Batched ct (x) p: B query ciphertexts against (B, num_ct, chunks, P,
    N) packed candidates, chunk-summed in the NTT domain (the staged
    pipeline: forward NTT, pointwise kernel, mod-sum, inverse NTT)."""
    c0 = torch.stack([q.c0 for q in q_cts])                # (B, chunks, P, N)
    c1 = torch.stack([q.c1 for q in q_cts])
    c0_out, c1_out = [], []
    for i, ctx in enumerate(params.ctxs):
        f0 = ntt_ops.ntt_fwd(c0[:, :, i, :], ctx)
        f1 = ntt_ops.ntt_fwd(c1[:, :, i, :], ctx)
        pk = packed[:, :, :, i, :].contiguous()            # (B, num_ct, chunks, N)
        prod0 = ntt_ops.pointwise_mul(pk, f0[:, None].expand(pk.shape), ctx)
        prod1 = ntt_ops.pointwise_mul(pk, f1[:, None].expand(pk.shape), ctx)
        acc0 = modring.mod_sum(prod0, ctx.q, ctx.mu, axis=2).to(torch.int32)
        acc1 = modring.mod_sum(prod1, ctx.q, ctx.mu, axis=2).to(torch.int32)
        c0_out.append(ntt_ops.ntt_inv(acc0, ctx))
        c1_out.append(ntt_ops.ntt_inv(acc1, ctx))
    return ScoreCiphertextBatch(
        c0=torch.stack(c0_out, dim=2), c1=torch.stack(c1_out, dim=2),
        n_dim=n_dim, num_cands=num_cands)


def encrypted_scores_batch(params: RlweParams,
                           q_cts: Sequence[QueryCiphertext],
                           packed: torch.Tensor, num_cands: int,
                           n_dim: int) -> list:
    """List-of-lanes view of `encrypted_scores_batch_stacked`."""
    return encrypted_scores_batch_stacked(params, q_cts, packed, num_cands,
                                          n_dim).lanes()


def encrypted_scores(params: RlweParams, q_ct: QueryCiphertext,
                     packed: PackedCandidates) -> ScoreCiphertexts:
    """ct (x) p per candidate block (the B=1 slice of the batch version)."""
    assert q_ct.n_dim == packed.n_dim
    return encrypted_scores_batch(params, [q_ct], packed.polys[None],
                                  num_cands=packed.num_cands,
                                  n_dim=packed.n_dim)[0]


def cosine_distances(scores: np.ndarray) -> np.ndarray:
    """Paper Definition 2 over decrypted inner products."""
    return 1.0 - scores


__all__ = [
    "RlweParams", "RlweSecretKey", "QueryCiphertext", "PackedCandidates",
    "ScoreCiphertexts", "ScoreCiphertextBatch", "CandidateCache",
    "params_key", "build_candidate_cache", "keygen", "encrypt_query",
    "decrypt_scores", "decrypt_scores_batch", "decrypt_rns",
    "extract_scores", "pack_candidates", "pack_candidates_batch",
    "encrypted_scores", "encrypted_scores_batch",
    "encrypted_scores_batch_stacked", "encrypted_scores_cached",
    "encrypted_scores_cached_batch", "cosine_distances",
]
