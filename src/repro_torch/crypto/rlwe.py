"""RNS-RLWE additively homomorphic encryption ("BFV-lite"), PyTorch.

Counterpart of ``repro/crypto/rlwe.py``: the cold path, the dense
NTT-domain candidate cache and the corpus-scale `ShardedCandidateCache`
(host pool, LRU device-resident hot shards, async admitter, per-request
gather of the k' selected rows).  Scheme, packing and correctness budget
are the reference's; see its module docstring.

  ring      R_q = Z_q[X]/(X^N + 1),  q = q_0 q_1 q_2  (RNS, ~20-bit NTT primes)
  enc(m)    c0 = a*s + e + Delta*m,  c1 = a;   a ~ U(R_q), e ~ CBD(eta)
  ct (x) p  (c0*p, c1*p) for a plaintext p; candidates packed reversed

Host randomness is the reference's: keygen and encryption draw from a
``numpy.random.Generator`` in the same order, so keys and ciphertexts are
bit-identical to the JAX package's.  Everything else runs on the device of
the key (user side) or of the candidate cache (cloud side) through
`repro_torch.kernels.ntt.ops`, which launches the CUDA kernels on CUDA
tensors.  Decryption's CRT lift runs there too, exactly in int64, so only
the scores return to the host.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.crypto import modring
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.launch import mesh as mesh_lib


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
                  rng: np.random.Generator, *,
                  tracer=obs.NULL_TRACER) -> QueryCiphertext:
    """Encrypt a unit-norm query embedding of any dimension (chunked), on
    the key's device.  The host draws (per chunk: the noise, then one
    uniform ``a`` per prime) keep the reference's order; ``a`` is laid out
    (chunks, P, N) as it is drawn, so one copy to the device is the
    ciphertext's c1 and one key product (`ntt_ops.key_mul`, every prime in
    one launch on the card) gives a*s.  ``tracer`` times the host draws
    and the host e + Delta*m arithmetic (``encrypt_draw``)."""
    p = sk.params
    dev = sk.s_ntt.device
    n_dim = e.shape[-1]
    chunks = p.num_chunks(n_dim)
    with tracer.span("encrypt_draw"):
        ints = _fixed_point(e, p.scale_q)
        m = np.zeros((chunks, p.n_poly), np.int64)
        err = np.zeros((chunks, p.n_poly), np.int64)
        a = np.zeros((chunks, p.num_primes, p.n_poly), np.int32)
        for c in range(chunks):
            seg = ints[c * p.chunk:(c + 1) * p.chunk]
            m[c, : len(seg)] = seg
            # signed (centered) encoding: Delta*m mod q per RNS prime (see
            # the reference for why an unsigned mod-t lift would break
            # plain-mult)
            err[c] = _cbd(rng, p.eta, p.n_poly)
            for i, ctx in enumerate(p.ctxs):
                a[c, i] = rng.integers(0, ctx.q,
                                       size=(p.n_poly,)).astype(np.int32)
        # e + Delta*m mod q_i on the host, (chunks, P, N): canonical, so
        # the device sum with a*s below 2q fits int32 and one remainder
        # ends it
        q = np.array(p.primes, np.int64)[:, None]
        delta = np.array([p.delta % qi for qi in p.primes],
                         np.int64)[:, None]
        em = np.mod(err[:, None] + delta * np.mod(m[:, None], q) % q, q)
    c1 = torch.from_numpy(a).to(dev)
    a_s = ntt_ops.key_mul(c1, sk.s_ntt, p.ctxs)
    c0 = torch.remainder(a_s + torch.from_numpy(em.astype(np.int32)).to(dev),
                         modring.rns_tables(p.ctxs, dev).q)
    return QueryCiphertext(c0=c0, c1=c1, n_dim=n_dim)


def _decrypt_d(params: RlweParams, s_ntt: torch.Tensor, c0: torch.Tensor,
               c1: torch.Tensor) -> torch.Tensor:
    """d = c0 - c1*s over every prime, on the key's device: one key product
    (`ntt_ops.key_mul`) and one modular subtraction; int32 (..., P, N)."""
    c1s = ntt_ops.key_mul(c1, s_ntt, params.ctxs)
    return modring.mod_sub(c0, c1s, modring.rns_tables(params.ctxs, c1.device).q)


def decrypt_rns(params: RlweParams, s_ntt: torch.Tensor, c0: torch.Tensor,
                c1: torch.Tensor) -> np.ndarray:
    """RNS phase of decryption: d = c0 - c1*s over every prime, as
    host int64 (..., P, N) — the counterpart of the reference's
    ``decrypt_rns``, for callers that want all of d.

    ``c0``/``c1`` are (..., P, N); ``s_ntt`` broadcasts against the leading
    dims of c1 — (P, N) for one key or (B, 1, P, N) for per-tenant keys.
    Decryption of scores (`decrypt_scores_batch`) does not copy d: it
    reads the extraction coefficients on the device."""
    return _decrypt_d(params, s_ntt, c0, c1).cpu().numpy().astype(np.int64)


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


def _extraction_index(params: RlweParams, n_dim: int, num_cands: int,
                      device: torch.device) -> tuple:
    """(ciphertext, coefficient) of candidates 0..num_cands-1, as
    `extract_scores` reads them: int64 (num_cands,) each, on ``device``."""
    cpt = params.cands_per_ct(n_dim)
    cand = torch.arange(num_cands, device=device)
    return (torch.div(cand, cpt, rounding_mode="floor"),
            cand % cpt * params.stride(n_dim) + params.chunk - 1)


def _lift_scores(params: RlweParams, r: torch.Tensor) -> torch.Tensor:
    """`extract_scores`' lift of residues ``r`` (..., P) of x in [0, Q),
    in int64 tensor ops on r's device: float64 scores (...).

    Garner's mixed radix gives x = v_0 + q_0 v_1 + ... + q_0..q_{P-2}
    v_{P-1} with v_i in [0, q_i); carrying t*x through the same radix
    gives floor(t*x / Q) and the remainder's digits, and the remainder
    against Q // 2 (digit by digit from the top; Q is odd, so no ties)
    rounds it.  Centring x first shifts the quotient by exactly t, which
    the final mod t removes.  Every intermediate stays below
    max(q_i q_j, t (q_i + 1)) < 2^62 for primes below 2^31 and t < 2^31,
    whatever the number of primes.

    `extract_scores` rounds the float64 quotient instead; the two could
    part only where t*x/Q lies within that float's rounding of a
    half-integer, which a decryption inside the noise budget never nears
    (its quotient sits within the noise's share of an integer)."""
    qs, t = params.primes, params.t
    assert max(qs) < 1 << 31 and t < 1 << 31
    r = r.to(torch.int64)
    v = [r[..., 0]]
    for i in range(1, len(qs)):
        acc = v[-1]                     # v_0 + q_0 v_1 + ... mod q_i, Horner
        for j in range(i - 2, -1, -1):
            acc = (acc * qs[j] + v[j]) % qs[i]
        inv = pow(math.prod(qs[:i]) % qs[i], -1, qs[i])
        v.append((r[..., i] - acc) % qs[i] * inv % qs[i])
    carry = torch.zeros_like(v[0])
    digits = []
    for vi, qi in zip(v, qs):
        s = vi * t + carry
        digits.append(s % qi)
        carry = torch.div(s, qi, rounding_mode="floor")
    half, half_digits = params.big_q // 2, []
    for qi in qs:
        half, hd = divmod(half, qi)
        half_digits.append(hd)
    above = equal = None
    for dg, hd in zip(reversed(digits), reversed(half_digits)):
        gt, eq = dg > hd, dg == hd
        above = gt if above is None else above | (equal & gt)
        equal = eq if equal is None else equal & eq
    val = (carry + above + t // 2) % t - t // 2
    return val.to(torch.float64) / float(params.scale_q * params.scale_c)


def decrypt_scores(sk: RlweSecretKey, res: ScoreCiphertexts) -> np.ndarray:
    """Decrypt packed inner products -> float scores (len num_cands):
    `decrypt_scores_batch` on a batch of one."""
    return decrypt_scores_batch([sk], ScoreCiphertextBatch(
        c0=res.c0[None], c1=res.c1[None], n_dim=res.n_dim,
        num_cands=res.num_cands))[0]


def decrypt_scores_batch(sks: Sequence[RlweSecretKey], cts, *,
                         tracer=obs.NULL_TRACER) -> list:
    """Decrypt B score ciphertexts under B (distinct) tenant keys, on the
    keys' device down to the scores: one key-product launch over every
    lane and prime, the modular subtraction, a gather of each candidate's
    extraction coefficient (per prime) and an exact int64 CRT lift
    (`_lift_scores`); only the (B, k') float64 scores cross to the host.
    Equal to `extract_scores` on `decrypt_rns`'s d, bit for bit.  ``cts``
    is a list of ScoreCiphertexts (lanes may differ in ``n_dim`` and
    ``num_cands``) or a ScoreCiphertextBatch; returns one (num_cands,)
    array a lane.

    ``tracer`` gets three spans: ``decrypt_crt``, the host's launch of the
    gather and lift; then, after a device mark (`Tracer.mark_device`,
    stage ``decrypt``) recorded behind the lift, ``decrypt_wait``, the
    host blocked on that mark (every earlier device operation in stream
    order, which the copy would wait for anyway); and ``decrypt_copy``,
    the scores' copy to the host (``bytes`` = lanes x widest k' x 8).
    The stream is then drained, where `Tracer.anchor_device` anchors the
    dispatch's device marks."""
    params = sks[0].params
    if isinstance(cts, ScoreCiphertextBatch):
        c0, c1 = cts.c0, cts.c1
        meta = [(cts.n_dim, cts.num_cands)] * cts.batch
    else:
        c0 = torch.stack([c.c0 for c in cts])
        c1 = torch.stack([c.c1 for c in cts])
        meta = [(c.n_dim, c.num_cands) for c in cts]
    s_ntt = torch.stack([sk.s_ntt for sk in sks])[:, None]  # (B, 1, P, N)
    d = _decrypt_d(params, s_ntt, c0, c1)                   # (B, num_ct, P, N)
    lanes, dev = len(meta), d.device
    with tracer.span("decrypt_crt", lanes=lanes,
                     num_cands=sum(nc for _, nc in meta)):
        width = max(nc for _, nc in meta)
        index = {nd: _extraction_index(params, nd, width, dev)
                 for nd in {nd for nd, _ in meta}}
        # a lane's slots past its own k' are sliced off below; clamped,
        # they stay inside d where lanes of another n_dim pack more a
        # ciphertext
        ct = torch.stack([index[nd][0] for nd, _ in meta]).clamp_(
            max=d.shape[1] - 1)                                # (B, width)
        coeff = torch.stack([index[nd][1] for nd, _ in meta])
        lane = torch.arange(lanes, device=dev)[:, None]
        scores = _lift_scores(params, d[lane, ct, :, coeff])   # (B, width)
    ready = tracer.mark_device("decrypt", dev)
    with tracer.span("decrypt_wait", lanes=lanes):
        if ready is not None:
            ready.synchronize()
    with tracer.span("decrypt_copy", lanes=lanes,
                     bytes=scores.numel() * scores.element_size()):
        out = scores.cpu().numpy()
    tracer.anchor_device()
    return [out[b, :nc] for b, (_, nc) in enumerate(meta)]


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

    @functools.cached_property
    def twiddles_shoup(self) -> torch.Tensor:
        """(P, cpt, N) Shoup quotients of ``twiddles`` (`_twiddles_shoup`),
        built on first use."""
        return _twiddles_shoup(self.params, self.twiddles)

    @property
    def nbytes(self) -> int:
        return self.polys.numel() * 4

    def host_pool(self) -> np.ndarray:
        """Host copy of the packed pool, memoized on first use so every
        sharded re-view (`shard_candidate_cache`) shares ONE host array no
        matter how many configs consume it.  Zero-copy on the CPU; on the
        card one block-wise device-to-host copy through small pinned
        staging buffers into a pageable array (the pool is never packed a
        second time)."""
        pool = self.__dict__.get("_host_pool")
        if pool is None:
            # frozen dataclass: memoize via __dict__ (cached_property style)
            pool = self.__dict__["_host_pool"] = _device_to_host(self.polys)
        return pool

    def check_compatible(self, params: RlweParams, n_dim=None) -> None:
        _check_cache_compatible(self, params, n_dim)


# pinned staging block for host <-> device pool copies (per buffer)
_STAGE_BYTES = 64 << 20


def _stage_rows(t_shape) -> int:
    """Rows of an int32 (rows, ...) tensor per pinned staging buffer."""
    return max(1, _STAGE_BYTES // max(4 * math.prod(t_shape[1:]), 1))


def _device_to_host(t: torch.Tensor) -> np.ndarray:
    """(rows, ...) int32 tensor -> host numpy array.  A CPU tensor is
    returned as a view; a CUDA tensor is copied in row blocks through two
    alternating pinned buffers (the device copy of one block overlaps the
    host copy of the previous one)."""
    if t.device.type == "cpu":
        return t.numpy()
    out = np.empty(tuple(t.shape), np.int32)
    host = torch.from_numpy(out)
    block = _stage_rows(t.shape)
    bufs = [torch.empty((block,) + tuple(t.shape[1:]), dtype=t.dtype,
                        pin_memory=True) for _ in range(2)]
    inflight: list = [None, None]        # (event, lo, hi) per buffer

    def drain(j):
        ev, lo, hi = inflight[j]
        ev.synchronize()
        host[lo:hi].copy_(bufs[j][:hi - lo])
        inflight[j] = None

    for i, lo in enumerate(range(0, t.shape[0], block)):
        j = i % 2
        if inflight[j] is not None:
            drain(j)
        hi = min(lo + block, t.shape[0])
        bufs[j][:hi - lo].copy_(t[lo:hi], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        inflight[j] = (ev, lo, hi)
    for j in (0, 1):
        if inflight[j] is not None:
            drain(j)
    return out


def _host_to_device(src: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows -> a new tensor on ``device``, allocated and copied on the
    caller's current stream (the admitter's side stream) in row blocks
    through two alternating pinned buffers; the caller synchronizes.  On
    the CPU the pool rows themselves are returned (no copy)."""
    t = torch.from_numpy(src)
    if device.type == "cpu":
        return t
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device=device)
    block = _stage_rows(t.shape)
    bufs = [torch.empty((block,) + tuple(t.shape[1:]), dtype=t.dtype,
                        pin_memory=True) for _ in range(2)]
    events: list = [None, None]
    for i, lo in enumerate(range(0, t.shape[0], block)):
        j = i % 2
        if events[j] is not None:
            events[j].synchronize()      # the buffer's previous copy is done
        hi = min(lo + block, t.shape[0])
        bufs[j][:hi - lo].copy_(t[lo:hi])
        out[lo:hi].copy_(bufs[j][:hi - lo], non_blocking=True)
        events[j] = torch.cuda.Event()
        events[j].record()
    return out


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


def _pack_corpus_ntt(params: RlweParams, emb: torch.Tensor, *,
                     host: bool = False, ntt_fwd=None):
    """The corpus half of negacyclic packing: every document's chunks
    reverse-packed at slot 0 and forward-NTT'd per prime, (num_docs,
    chunks, P, N) int32 — a tensor on ``emb``'s device, or with ``host``
    a host numpy pool (the sharded cache's backing store).  ``ntt_fwd``
    (default `ntt_ops.ntt_fwd`: the kernel on the card) lets a check run
    the same packing through the NTT's plain version on the card.

    The reference packs the whole corpus on the host and copies it over;
    at 10^6 documents the pool is ~49 GB, so here the same arithmetic
    (fixed point, reversed placement, mod q, forward NTT) runs in document
    blocks on ``emb``'s device, each block written into the preallocated
    pool (for a host pool, copied out block by block)."""
    num_docs, n_dim = emb.shape
    chunks, _, _ = _cache_geometry(params, n_dim)
    shape = (num_docs, chunks, params.num_primes, params.n_poly)
    if host:
        out = np.empty(shape, np.int32)
        pool = torch.from_numpy(out)
    else:
        pool = out = torch.empty(shape, dtype=torch.int32, device=emb.device)
    block = max(1, (1 << 24) // (chunks * params.n_poly))
    for lo in range(0, num_docs, block):
        ints = _fixed_point_t(emb[lo:lo + block], params.scale_c)  # (b, n_dim)
        polys = torch.zeros((ints.shape[0], chunks, params.n_poly),
                            dtype=torch.int64, device=emb.device)
        for c in range(chunks):
            seg = ints[:, c * params.chunk:(c + 1) * params.chunk]
            # p[chunk - 1 - j] = seg[j]
            polys[:, c, params.chunk - seg.shape[1]:params.chunk] = seg.flip(-1)
        fwd = ntt_ops.ntt_fwd if ntt_fwd is None else ntt_fwd
        blk = torch.stack([
            fwd(torch.remainder(polys, ctx.q).to(torch.int32), ctx)
            for ctx in params.ctxs], dim=2)                # (b, chunks, P, N)
        pool[lo:lo + ints.shape[0]].copy_(blk)
    return out


def _slot_twiddles(params: RlweParams, n_dim: int,
                   device: torch.device) -> torch.Tensor:
    """NTT-domain diagonals of the slot monomials X^{s*stride}: (P, cpt, N)."""
    _, stride, cpt = _cache_geometry(params, n_dim)
    mono = np.zeros((cpt, params.n_poly), np.int64)
    mono[np.arange(cpt), np.arange(cpt) * stride] = 1
    return _ntt_per_prime(_to_rns(mono, params), params, device)


def _twiddles_shoup(params: RlweParams,
                    twiddles: torch.Tensor) -> torch.Tensor:
    """Shoup quotients floor(w * 2^32 / q_p) of the slot twiddles (P, cpt,
    N), for the fused re-rank kernel's rotate (the NTT's tables are built
    the same way, `PrimeCtx.table`)."""
    q = torch.tensor(params.primes, dtype=torch.int64,
                     device=twiddles.device).view(-1, 1, 1)
    return modring.shoup_quotients(twiddles, q)


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


# ---------------------------------------------------------------------------
# cloud side: sharded device-resident candidate cache (corpus scale)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateCacheConfig:
    """Knobs for the sharded candidate cache (hashable: `FlatIndex` memoizes
    one cache per (RlweParams value, config) pair).  The reference's
    docstring (``repro/crypto/rlwe.py``) states each knob's regime.

    shard_docs / num_shards   contiguous document ranges (``shard_docs``
                              wins); default 8 shards.
    max_resident_bytes        device budget for LRU-pinned hot shards
                              (``None`` unbounded, ``0`` stream-only).
    pin_on_access             allow admission of missed shards.
    async_admission           background admitter (True) or synchronous
                              first-touch LRU (False, the replay mode).
    admit_threshold           (async) admit on the n-th touch in a window.
    admit_window              (async) halve every touch counter each
                              ``admit_window`` counted touches; ``None``
                              resolves to ``max(8, num_shards)``.
    max_pending_admissions    (async) bound on queued admissions; excess
                              requests are dropped and counted.
    """
    shard_docs: Optional[int] = None
    num_shards: Optional[int] = None
    max_resident_bytes: Optional[int] = None
    pin_on_access: bool = True
    async_admission: bool = True
    admit_threshold: int = 2
    admit_window: Optional[int] = None
    max_pending_admissions: int = 4

    def __post_init__(self):
        # CLI-reachable knobs: fail loudly at construction, not mid-serve
        if self.admit_threshold < 1:
            raise ValueError(
                f"admit_threshold must be >= 1, got {self.admit_threshold}")
        if self.admit_window is not None and self.admit_window < 1:
            raise ValueError(
                f"admit_window must be >= 1, got {self.admit_window}")
        if self.max_pending_admissions < 1:
            raise ValueError(f"max_pending_admissions must be >= 1, got "
                             f"{self.max_pending_admissions}")

    def resolve_admit_window(self, num_shards: int) -> int:
        """``None`` -> the regime-separating auto window."""
        if self.admit_window is not None:
            return self.admit_window
        return max(8, num_shards)

    def resolve_shard_docs(self, num_docs: int) -> int:
        if self.shard_docs is not None:
            if self.shard_docs <= 0:        # CLI-reachable: fail loudly
                raise ValueError(
                    f"shard_docs must be positive, got {self.shard_docs}")
            return self.shard_docs
        n_shards = self.num_shards if self.num_shards is not None else 8
        if n_shards <= 0:
            raise ValueError(f"num_shards must be positive, got {n_shards}")
        return max(1, -(-num_docs // n_shards))


@dataclasses.dataclass(eq=False)
class ShardedCandidateCache:
    """Capacity-aware sharded view of the NTT-domain candidate pool.

    The per-document plaintexts live in a flat host pool (pageable numpy)
    partitioned into contiguous document shards: shard s owns documents
    ``[starts[s], starts[s + 1])`` of a boundary table that is uniform
    (``d // shard_docs``) at build and grows by one ragged tail shard per
    `ingest_tail`; earlier boundaries never move.  The device (the
    twiddles' device) holds only an LRU set of pinned hot shards bounded by
    ``max_resident_bytes`` and the per-request gather buffer of the k'
    selected rows (`index_select` from a resident shard, or a host row
    gather through a pinned buffer for a non-resident one).  Gathered rows
    are the exact pool rows the dense cache would select, so sharded
    scoring is bit-identical to the dense cache whatever the resident set,
    eviction history or in-flight admission.

    Admission (see `CandidateCacheConfig`) follows the reference: in async
    mode a missed shard's decayed touch counter must reach
    ``admit_threshold`` before an admission is enqueued to the background
    admitter thread; `gather` never waits on it.  The admitter copies the
    shard on its own CUDA stream (pinned staging blocks), synchronizes the
    copy's event, and only then swaps the shard in under the cache lock.
    A gather reading a resident shard records its own stream on the shard
    tensor, so an eviction cannot hand the shard's memory to the next
    admission while that gather still reads it.  The thread retires as
    soon as its queue is empty; `flush` and `close` wait for the queue and
    join it.  With ``async_admission=False`` admission is the synchronous
    first-touch LRU whose traces the determinism tests replay.
    ``hits``/``misses`` count shard-group lookups (one per distinct shard
    touched by a gather), not documents.

    Streaming ingestion (`ingest_tail`) publishes a packed tail shard under
    the lock in one step, so a concurrent gather sees the shard table
    before it or after it, never between, and enqueues the tail to the
    same admitter.

    Row-sharded pinned shards (``placement`` = (mesh, row axes), from
    `FlatIndex.shard_placement`): a rank's device copy of a pinned shard is
    its ``shard_docs / n`` rows at its position over the row axes, so its
    device holds 1/n of every resident shard while ``max_resident_bytes``,
    ``resident_bytes`` and ``peak_resident_bytes`` keep counting whole
    shards (the same shards are admitted as without the placement;
    ``device_resident_bytes`` is what this rank holds).  Each row of a
    shard has one owner position; a `gather` fills the selected rows this
    rank owns, from its resident part or from the host pool (whole on every
    rank), leaves the others zero, and one int32 all-reduce sum over the
    row axes assembles them exactly.  Every rank issues that collective on
    every gather, and what it exchanges depends on the ids alone, never on
    residency or the admitter's timing.
    """
    params: RlweParams
    twiddles: torch.Tensor         # (P, cpt, N) — same as the dense cache
    n_dim: int
    num_docs: int
    stride: int
    cands_per_ct: int
    num_chunks: int
    shard_docs: int
    pool: np.ndarray               # host (num_docs, chunks, P, N) backing store
    shards: list                   # views into ``pool``, <= shard_docs docs each
    epoch: int = 0                 # corpus epoch (bumped by `ingest_tail`)
    max_resident_bytes: Optional[int] = None
    pin_on_access: bool = True
    async_admission: bool = True
    admit_threshold: int = 2
    admit_window: int = 64
    max_pending_admissions: int = 4
    placement: Optional[tuple] = None     # (mesh, row axes): row-sharded pins
    _resident: collections.OrderedDict = dataclasses.field(
        default_factory=collections.OrderedDict, repr=False)
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    gathered_bytes: int = 0        # host->device on-demand row traffic
    peak_resident_bytes: int = 0
    admissions: int = 0            # completed admissions (sync + async + pin)
    async_admissions: int = 0      # ... of which completed on the admitter
    prefetches: int = 0            # shard touches recorded via `prefetch`
    admit_enqueued: int = 0        # admissions handed to the admitter
    admit_dropped: int = 0         # admission requests dropped (queue full)
    policy_deferrals: int = 0      # touches below admit_threshold (no admit)
    admit_failures: int = 0        # admitter copies that raised (dropped)
    ingests: int = 0               # tail shards appended since build

    @functools.cached_property
    def twiddles_shoup(self) -> torch.Tensor:
        """As `CandidateCache.twiddles_shoup`."""
        return _twiddles_shoup(self.params, self.twiddles)

    def __post_init__(self):
        # one lock guards the resident set + policy counters; the
        # condition wakes `flush` waiters when an admission completes
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._inflight: set = set()       # enqueued or mid-copy shard ids
        self._touch_counts: dict = {}     # shard id -> decayed touch count
        self._touches = 0                 # counted touches since build
        self._prefetched: set = set()     # touches already counted upstream
        self._worker: Optional[threading.Thread] = None
        self._side_stream = None          # the admitter's CUDA stream
        self._admit_hook = None           # test seam: called(s) pre-copy
        self._ingest_hook = None          # test seam: called(self) pre-publish
        # shard boundary table: shard s owns docs [starts[s], starts[s+1])
        self._starts = np.cumsum(
            [0] + [sh.shape[0] for sh in self.shards])[:-1]
        # telemetry sink, re-bound by the serving engine every dispatch
        self.tracer = obs.NULL_TRACER
        self._trace_batch: Optional[int] = None
        # row-sharded pinned shards: this rank's rows [pos, pos + 1) * part
        self._parts, self._pos = 1, 0
        if self.placement is not None:
            mesh, axes = self.placement
            self._parts = mesh_lib.axes_size(mesh, axes)
            self._pos = mesh_lib.axes_position(mesh, axes)
            if any(sh.shape[0] != self.shard_docs for sh in self.shards) \
                    or self.shard_docs % self._parts:
                raise ValueError(
                    f"a row-sharded placement needs whole shards of "
                    f"shard_docs={self.shard_docs} docs that split over "
                    f"{self._parts} ranks")

    def set_trace_context(self, tracer, batch_id: Optional[int]) -> None:
        """Bind the tracer + current batch id for spans this cache emits
        (including admissions completed later on the admitter thread)."""
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self._trace_batch = batch_id

    @property
    def device(self) -> torch.device:
        return self.twiddles.device

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def pool_nbytes(self) -> int:
        """Total host pool size — what the dense cache would hold on device."""
        return sum(s.nbytes for s in self.shards)

    def host_pool(self) -> np.ndarray:
        """The whole packed pool, ingested tail shards included: the
        backing array while the cache never grew, else one concatenated
        copy (re-view and densify only; requests read per shard)."""
        with self._lock:
            shards = list(self.shards)
        if self.pool.shape[0] == sum(sh.shape[0] for sh in shards):
            return self.pool
        return np.concatenate(shards, axis=0)

    def _resident_bytes_locked(self) -> int:
        """Whole-shard bytes of the resident set (the budget's unit)."""
        return sum(self.shards[s].nbytes for s in self._resident)

    @property
    def device_resident_bytes(self) -> int:
        """Bytes this rank's device holds for the resident set (1/n of
        `resident_bytes` under a row-sharded placement)."""
        with self._lock:
            return sum(v.numel() * v.element_size()
                       for v in self._resident.values())

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes_locked()

    @property
    def resident_shards(self) -> tuple:
        """Resident shard ids, LRU -> MRU."""
        with self._lock:
            return tuple(self._resident.keys())

    def stats(self) -> dict:
        # one lock scope: the admitter swaps/evicts concurrently
        with self._lock:
            resident_bytes = self._resident_bytes_locked()
            resident_shards = tuple(self._resident.keys())
            pending = len(self._inflight)
        device_bytes = self.device_resident_bytes
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "gathered_bytes": self.gathered_bytes,
                "resident_bytes": resident_bytes,
                "device_resident_bytes": device_bytes,
                "row_parts": self._parts,
                "peak_resident_bytes": self.peak_resident_bytes,
                "pool_bytes": self.pool_nbytes,
                "num_shards": self.num_shards,
                "resident_shards": resident_shards,
                "admissions": self.admissions,
                "async_admissions": self.async_admissions,
                "prefetches": self.prefetches,
                "admit_enqueued": self.admit_enqueued,
                "admit_dropped": self.admit_dropped,
                "policy_deferrals": self.policy_deferrals,
                "admit_failures": self.admit_failures,
                "pending_admissions": pending,
                "epoch": self.epoch,
                "ingests": self.ingests}

    def check_compatible(self, params: RlweParams, n_dim=None) -> None:
        _check_cache_compatible(self, params, n_dim)

    def shard_of(self, doc_id: int) -> int:
        return int(np.searchsorted(self._starts, int(doc_id),
                                   side="right")) - 1

    def _shard_ids(self, flat: np.ndarray, starts=None) -> np.ndarray:
        """Validated document ids -> shard ids (shared by `gather` and
        `prefetch`), by the boundary table ``starts`` (default: the current
        one): ``flat // shard_docs`` for the uniform build layout, and
        still right for ragged tail shards."""
        starts = self._starts if starts is None else starts
        num_docs = self.num_docs
        if flat.size and (flat.min() < 0 or flat.max() >= num_docs):
            # negative ids would alias shards[-1] via Python indexing and
            # silently gather the wrong document; fail loudly instead
            raise IndexError(
                f"candidate ids must be in [0, {num_docs}); got "
                f"[{flat.min()}, {flat.max()}]")
        return np.searchsorted(starts, flat, side="right") - 1

    def pin(self, shard_id: int) -> None:
        """Explicitly admit a shard to device residency (LRU position =
        most recent); evicts oldest shards if over budget.  Synchronous:
        the shard is resident on return."""
        with self.tracer.span("cache_pin", shard=int(shard_id),
                              batch_id=self._trace_batch):
            with self._lock:
                self._admit_locked(int(shard_id))

    # -- admission: shared swap-in (caller holds the lock) -------------------

    def _fits_budget(self, s: int) -> bool:
        return (self.max_resident_bytes is None
                or self.shards[s].nbytes <= self.max_resident_bytes)

    def _swap_in_locked(self, s: int, arr: torch.Tensor) -> None:
        """Install a completed device copy of shard ``s``: evict LRU-first
        down to budget, then publish."""
        nbytes = self.shards[s].nbytes
        if self.max_resident_bytes is not None:
            while (self._resident_bytes_locked() + nbytes
                   > self.max_resident_bytes):
                evicted, _ = self._resident.popitem(last=False)
                self.evictions += 1
                self.tracer.event("cache_evict", shard=int(evicted),
                                  batch_id=self._trace_batch)
        self._resident[s] = arr
        self.admissions += 1
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self._resident_bytes_locked())

    def _part_rows(self) -> int:
        """Rows of a shard one rank holds (all of them without placement)."""
        return self.shard_docs // self._parts

    def _stage_copy(self, s: int, stream=None) -> torch.Tensor:
        """A complete device copy of shard ``s`` (under a row-sharded
        placement: of this rank's rows of it), allocated and copied on
        ``stream`` (the current stream when None), finished before return."""
        src = self.shards[s]
        if self.placement is not None:
            part = self._part_rows()
            src = src[self._pos * part:(self._pos + 1) * part]
        if self.device.type == "cpu":
            return _host_to_device(src, self.device)
        stream = stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            arr = _host_to_device(src, self.device)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return arr

    def _admit_locked(self, s: int) -> None:
        """Synchronous admission (legacy mode, and `pin`): copy + swap."""
        if s in self._resident:
            self._resident.move_to_end(s)
            return
        if not self._fits_budget(s):
            return                  # shard alone exceeds the budget: stream
        with self.tracer.span("cache_admit", shard=int(s),
                              batch_id=self._trace_batch,
                              bytes=int(self.shards[s].nbytes)):
            self._swap_in_locked(s, self._stage_copy(s))

    # -- admission: frequency-aware policy + background admitter -------------

    def _touch_locked(self, s: int) -> None:
        """Count one (non-prefetched) touch of a missed shard and enqueue a
        background admission when the decayed counter reaches the
        threshold."""
        if self.max_resident_bytes == 0 or not self._fits_budget(s):
            return                  # stream-only / oversized: never admit
        self._touches += 1
        if self._touches % self.admit_window == 0:
            # decay: halve every counter each window; sub-1 entries age out
            self._touch_counts = {k: v / 2
                                  for k, v in self._touch_counts.items()
                                  if v >= 1.0}
        count = self._touch_counts.get(s, 0.0) + 1.0
        self._touch_counts[s] = count
        if count < self.admit_threshold:
            self.policy_deferrals += 1
            return
        if s in self._resident or s in self._inflight:
            return
        if len(self._queue) >= self.max_pending_admissions:
            self.admit_dropped += 1   # counter keeps it eligible next touch
            return
        self._touch_counts.pop(s, None)
        self._inflight.add(s)
        self._queue.append((s, self._trace_batch))
        self.admit_enqueued += 1
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._admit_worker, name="shard-admitter", daemon=True)
            self._worker.start()

    def _admit_worker(self) -> None:
        """Background admitter: drain the queue one shard at a time, then
        retire.  The copy runs outside the lock on this thread's own CUDA
        stream (the request path keeps streaming from the host pool
        meanwhile); only the final swap takes the lock.  Retiring and
        spawning both happen under the lock, so no admission can fall
        between a retiring worker and the next one."""
        while True:
            with self._cv:
                if not self._queue:
                    self._worker = None
                    self._cv.notify_all()
                    return
                s, parent = self._queue.popleft()
            tracer = self.tracer
            t0 = tracer.clock() if tracer.enabled else 0.0
            error = {}
            try:
                hook = self._admit_hook   # test seam: delay/observe the copy
                if hook is not None:
                    hook(s)
                if self.device.type == "cuda" and self._side_stream is None:
                    self._side_stream = torch.cuda.Stream(self.device)
                arr = self._stage_copy(s, self._side_stream)
            except Exception as e:        # noqa: BLE001 — a failed copy must
                arr = None                # not strand flush()/later admits;
                error = {"error_type": type(e).__name__}   # counted, traced
            swapped = False
            with self._cv:
                self._inflight.discard(s)
                if arr is None:
                    self.admit_failures += 1   # dropped; next touch retries
                elif s in self._resident:
                    self._resident.move_to_end(s)
                elif self._fits_budget(s) and self.max_resident_bytes != 0:
                    self._swap_in_locked(s, arr)
                    self.async_admissions += 1
                    swapped = True
                self._cv.notify_all()     # wake flush()
            if tracer.enabled:
                tracer.record("cache_admit", t0, tracer.clock(),
                              track="admitter", batch_id=parent,
                              shard=int(s),
                              bytes=int(self.shards[s].nbytes),
                              ok=swapped, **error)

    def prefetch(self, ids) -> int:
        """Serving-engine admission hook: record the shard touches implied
        by a batch's top-k' candidate ``ids`` and enqueue the admissions the
        policy grants now, before the request's encryption, so the
        background copy overlaps it.  The following `gather` of the same
        ids does not count these touches again.  Returns the number of
        shards touched; 0 when admission is off or synchronous."""
        if not (self.pin_on_access and self.async_admission):
            return 0
        flat = np.asarray(ids).reshape(-1)
        shard_ids = self._shard_ids(flat)
        if flat.size == 0:
            return 0
        tracer = self.tracer
        t0 = tracer.clock() if tracer.enabled else 0.0
        touched = 0
        with self._lock:
            # one fresh credit set per batch (see the reference)
            self._prefetched = set()
            for s in np.unique(shard_ids):
                s = int(s)
                if s in self._resident:
                    continue          # gather will hit; nothing to admit
                self._touch_locked(s)
                self._prefetched.add(s)
                self.prefetches += 1
                touched += 1
        if tracer.enabled:
            tracer.record("cache_prefetch", t0, tracer.clock(),
                          batch_id=self._trace_batch, shards=touched)
        return touched

    def flush(self, timeout: float = 60.0) -> None:
        """Block until every enqueued admission has completed and the
        admitter thread has exited (TimeoutError after ``timeout`` s).
        Request paths never need this; tests, benchmarks and `close` do."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight or self._worker is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"shard admissions did not drain within {timeout}s "
                        f"({len(self._queue)} queued, "
                        f"{len(self._inflight)} in flight)")
                self._cv.wait(remaining)
            worker = self._worker
        if worker is not None:
            worker.join(max(0.0, deadline - time.monotonic()))

    def close(self, timeout: float = 60.0) -> None:
        """Let pending admissions complete and join the admitter thread.
        Idempotent; the cache stays usable (a later admission starts a new
        worker)."""
        self.flush(timeout)

    def ingest_tail(self, rows: np.ndarray, *, epoch: int) -> None:
        """Streaming ingestion: append newly packed documents as a tail
        shard and stamp the cache with the new corpus ``epoch``.

        ``rows`` is the host `_pack_corpus_ntt` output for the new
        documents, complete before this call (as the admitter's staged
        copy is), so the publish under the lock is a list append and a new
        boundary table: a concurrent `gather` sees the shard table before
        the ingest or after it, never half of it.  Ids below the previous
        ``num_docs`` keep their shard (the table only grows), which is what
        keeps a fixed-epoch replay bit-identical while ingestion runs.  The
        tail shard then rides the existing admission path: enqueued to the
        background admitter (within the budget and the queue bound); until
        its swap, gathers stream its rows from the host."""
        rows = np.ascontiguousarray(rows, np.int32)
        want = (self.num_chunks, self.params.num_primes, self.params.n_poly)
        if rows.ndim != 4 or rows.shape[1:] != want:
            raise ValueError(
                f"tail shard rows must be (m, {want[0]}, {want[1]}, "
                f"{want[2]}), got {rows.shape}")
        if rows.shape[0] == 0:
            return
        hook = self._ingest_hook    # test seam: interleave pre-publish
        if hook is not None:
            hook(self)
        with self._cv:
            if epoch <= self.epoch:
                raise ValueError(
                    f"stale ingest epoch {epoch} (cache is at "
                    f"{self.epoch})")
            s = len(self.shards)
            self.shards.append(rows)
            self._starts = np.append(self._starts, self.num_docs)
            self.num_docs += rows.shape[0]
            self.epoch = epoch
            self.ingests += 1
            # warm the tail through the normal admission machinery
            if (self.pin_on_access and self.async_admission
                    and self.max_resident_bytes != 0
                    and self._fits_budget(s)
                    and len(self._queue) < self.max_pending_admissions):
                self._inflight.add(s)
                self._queue.append((s, self._trace_batch))
                self.admit_enqueued += 1
                if self._worker is None:
                    self._worker = threading.Thread(
                        target=self._admit_worker, name="shard-admitter",
                        daemon=True)
                    self._worker.start()
            self._cv.notify_all()

    def _host_rows(self, s: int, loc: np.ndarray) -> torch.Tensor:
        """Rows ``loc`` of non-resident shard ``s``, on the cache's device:
        a host row gather into a pinned buffer, then one copy to the card
        (the caching host allocator keeps the buffer until it completes)."""
        src = torch.from_numpy(self.shards[s])
        idx = torch.from_numpy(np.ascontiguousarray(loc, np.int64))
        if self.device.type == "cpu":
            return src.index_select(0, idx)
        buf = torch.empty((idx.numel(),) + tuple(src.shape[1:]),
                          dtype=src.dtype, pin_memory=True)
        torch.index_select(src, 0, idx, out=buf)
        return buf.to(self.device, non_blocking=True)

    def gather(self, ids, *, mesh=None) -> torch.Tensor:
        """On-demand gather of the selected candidates' cached rows:
        (B, num_cands) document ids -> (B, num_cands, chunks, P, N) on the
        cache's device, touching only those documents.

        Ids are grouped by shard; resident shards gather device-side
        (`index_select`), non-resident shards gather just the selected rows
        from the host pool.  With ``pin_on_access`` a miss feeds the
        admission policy (synchronous first-touch LRU admission in legacy
        mode, else a counted touch that may enqueue a background admission
        — the gather itself never waits on the copy).  Under a row-sharded
        placement this rank reads only the selected rows it owns and one
        all-reduce over the row axes assembles the rest (collective: every
        rank of the placement calls it with the same ids), on ``mesh`` (a
        `launch.mesh.fork` of the placement's mesh, as each serving engine
        passes its own; default the placement's)."""
        ids = np.asarray(ids)
        if ids.ndim != 2:
            raise ValueError(f"ids must be (B, num_cands), got {ids.shape}")
        bsz, nc = ids.shape
        tracer = self.tracer
        t0 = tracer.clock() if tracer.enabled else 0.0
        h0, m0, g0 = self.hits, self.misses, self.gathered_bytes
        flat = ids.reshape(-1).astype(np.int64)
        starts = self._starts     # one table: ingest_tail swaps it whole
        shard_ids = self._shard_ids(flat, starts)
        local = flat - starts[shard_ids]
        order = np.argsort(shard_ids, kind="stable")      # group by shard
        uniq, starts = np.unique(shard_ids[order], return_index=True)
        bounds = np.append(starts, order.size)
        row_shape = (self.num_chunks, self.params.num_primes,
                     self.params.n_poly)
        alloc = torch.zeros if self.placement is not None else torch.empty
        out = alloc((flat.size,) + row_shape, dtype=torch.int32,
                    device=self.device)
        part = self._part_rows()
        for s, lo, hi in zip(uniq, bounds[:-1], bounds[1:]):
            s = int(s)
            sel = order[lo:hi]
            loc = local[sel]
            if self.placement is not None:
                # this rank's rows of the shard; the all-reduce brings the
                # others (the policy below still sees every touched shard)
                owned = loc // part == self._pos
                sel, loc = sel[owned], loc[owned]
            with self._lock:                  # vs admitter swap/evict
                dev = self._resident.get(s)
                if dev is not None:
                    self.hits += 1
                    self._resident.move_to_end(s)         # LRU touch
                    self._prefetched.discard(s)   # credit no longer needed
                elif self.pin_on_access:
                    if not self.async_admission:
                        self._admit_locked(s)
                    elif s in self._prefetched:
                        self._prefetched.discard(s)   # counted at prefetch
                    else:
                        self._touch_locked(s)
            if not sel.size:
                continue
            if dev is not None:
                at = loc - self._pos * part if self.placement is not None \
                    else loc
                rows = dev.index_select(
                    0, torch.from_numpy(at).to(self.device))
                if self.device.type == "cuda":
                    # an eviction frees ``dev``; its memory must not go to
                    # the next admission before this stream has read it
                    dev.record_stream(torch.cuda.current_stream(self.device))
            else:
                self.misses += 1
                rows = self._host_rows(s, loc)
                self.gathered_bytes += rows.numel() * 4
            out.index_copy_(0, torch.from_numpy(sel).to(self.device), rows)
        if self.placement is not None:
            base, axes = self.placement
            out = mesh_lib.all_reduce(out, base if mesh is None else mesh,
                                      axes)
        out = out.reshape((bsz, nc) + row_shape)
        if tracer.enabled:
            tracer.record("cache_gather", t0, tracer.clock(),
                          batch_id=self._trace_batch, lanes=int(bsz),
                          num_cands=int(nc), shards=int(uniq.size),
                          hits=self.hits - h0, misses=self.misses - m0,
                          bytes=self.gathered_bytes - g0)
        return out


def _shard_pool(params: RlweParams, pool: np.ndarray, n_dim: int,
                config: CandidateCacheConfig, twiddles: torch.Tensor,
                epoch: int = 0, placement: Optional[tuple] = None
                ) -> ShardedCandidateCache:
    num_docs = pool.shape[0]
    chunks, stride, cpt = _cache_geometry(params, n_dim)
    shard_docs = config.resolve_shard_docs(num_docs)
    shards = [pool[lo:lo + shard_docs]                    # views, no copy
              for lo in range(0, num_docs, shard_docs)]
    return ShardedCandidateCache(
        params=params, twiddles=twiddles, n_dim=n_dim,
        num_docs=num_docs, stride=stride, cands_per_ct=cpt,
        num_chunks=chunks, shard_docs=shard_docs, pool=pool, shards=shards,
        epoch=epoch,
        max_resident_bytes=config.max_resident_bytes,
        pin_on_access=config.pin_on_access,
        async_admission=config.async_admission,
        admit_threshold=config.admit_threshold,
        admit_window=config.resolve_admit_window(len(shards)),
        max_pending_admissions=config.max_pending_admissions,
        placement=placement)


def build_sharded_candidate_cache(
        params: RlweParams, embeddings: torch.Tensor, *,
        config: Optional[CandidateCacheConfig] = None,
        placement: Optional[tuple] = None) -> ShardedCandidateCache:
    """Pack + forward-NTT the corpus once, on the embeddings' device, into
    a host pool, and partition it into shards (resident shards and gathers
    live on the embeddings' device); ``placement`` row-shards the pinned
    shards (see `ShardedCandidateCache`)."""
    config = config if config is not None else CandidateCacheConfig()
    n_dim = embeddings.shape[1]
    pool = _pack_corpus_ntt(params, embeddings, host=True)
    return _shard_pool(params, pool, n_dim, config,
                       _slot_twiddles(params, n_dim, embeddings.device),
                       placement=placement)


def shard_candidate_cache(cache, config: Optional[CandidateCacheConfig] = None,
                          placement: Optional[tuple] = None
                          ) -> ShardedCandidateCache:
    """Re-view an existing cache's pool (dense `CandidateCache` or another
    `ShardedCandidateCache`) as a sharded cache under a new config, without
    re-packing: the dense cache's memoized host pool is shared by every
    view, and bit identity between the views holds by construction."""
    config = config if config is not None else CandidateCacheConfig()
    return _shard_pool(cache.params, cache.host_pool(), cache.n_dim, config,
                       cache.twiddles, epoch=getattr(cache, "epoch", 0),
                       placement=placement)


def densify_candidate_cache(cache: ShardedCandidateCache) -> CandidateCache:
    """Dense device-resident view of a sharded cache's pool (one copy to
    the cache's device, no re-pack; the host pool stays shared)."""
    pool = cache.host_pool()
    dense = CandidateCache(
        params=cache.params,
        polys=torch.from_numpy(pool).to(cache.device),
        twiddles=cache.twiddles, n_dim=cache.n_dim,
        num_docs=pool.shape[0], stride=cache.stride,
        cands_per_ct=cache.cands_per_ct, num_chunks=cache.num_chunks)
    dense.__dict__["_host_pool"] = pool         # keep the pool shared
    return dense


def _ids_tensor(ids, device: torch.device) -> torch.Tensor:
    """Candidate ids (numpy, list or tensor) as int64 on ``device``."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(np.asarray(ids))
    return ids.to(device=device, dtype=torch.int64)


def _scores_pipeline(c0, c1, g, cache, ctxs):
    """Per prime the query forward NTTs and the fused rotate -> Hadamard ->
    slot/chunk mod-sum -> inverse NTT over the gathered rows ``g`` (B, nc,
    chunks, P, N), read in place on the card: the last result
    ciphertext's empty slots contribute nothing, as zero padding would."""
    num_cands = g.shape[1]
    outs0, outs1 = [], []
    for i, ctx in enumerate(ctxs):
        f0 = ntt_ops.ntt_fwd(c0[:, :, i, :], ctx)
        f1 = ntt_ops.ntt_fwd(c1[:, :, i, :], ctx)
        acc0, acc1 = ntt_ops.fused_rotate_hadamard_intt_gathered(
            g, i, num_cands, cache.twiddles[i], cache.twiddles_shoup[i], f0,
            f1, ctx)
        outs0.append(acc0)
        outs1.append(acc1)
    return torch.stack(outs0, dim=2), torch.stack(outs1, dim=2)


def encrypted_scores_cached_batch(params: RlweParams,
                                  q_cts: Sequence[QueryCiphertext],
                                  cache, cand_ids, *,
                                  mesh=None) -> ScoreCiphertextBatch:
    """Batched ct (x) p against cached NTT-domain candidates (``cache`` is a
    dense `CandidateCache` or a `ShardedCandidateCache`): one gather of k'
    cached rows per lane (device `index_select` for the dense cache, the
    shard-grouped on-demand gather for the sharded one), then per prime 2
    query forward NTTs and one fused rotate -> Hadamard -> mod-sum ->
    inverse-NTT launch.  Identical pipeline below the gather for both
    kinds, so both are bit identical to `pack_candidates_batch` +
    `encrypted_scores_batch_stacked`.  ``mesh``: the mesh a row-sharded
    cache's gather runs on (`ShardedCandidateCache.gather`)."""
    sharded = isinstance(cache, ShardedCandidateCache)
    if sharded:
        ids = np.asarray(cand_ids.cpu() if isinstance(cand_ids, torch.Tensor)
                         else cand_ids)
    else:
        ids = _ids_tensor(cand_ids, cache.polys.device)
    if ids.ndim != 2:
        raise ValueError(f"cand_ids must be (B, num_cands), got {ids.shape}")
    bsz, num_cands = ids.shape
    assert len(q_cts) == bsz
    cache.check_compatible(params, q_cts[0].n_dim)
    c0 = torch.stack([q.c0 for q in q_cts])                # (B, chunks, P, N)
    c1 = torch.stack([q.c1 for q in q_cts])
    if sharded:
        g = cache.gather(ids, mesh=mesh)       # (B, nc, chunks, P, N)
    else:
        g = cache.polys.index_select(0, ids.reshape(-1)).reshape(
            (bsz, num_cands) + tuple(cache.polys.shape[1:]))
    all0, all1 = _scores_pipeline(c0, c1, g, cache, params.ctxs)
    return ScoreCiphertextBatch(c0=all0, c1=all1, n_dim=cache.n_dim,
                                num_cands=num_cands)


def encrypted_scores_cached(params: RlweParams, q_ct: QueryCiphertext,
                            cache, cand_ids, *,
                            mesh=None) -> ScoreCiphertexts:
    """Cached ct (x) p for one query (the B=1 slice of the batch version)."""
    if isinstance(cand_ids, torch.Tensor):
        cand_ids = cand_ids.cpu().numpy()
    return encrypted_scores_cached_batch(
        params, [q_ct], cache, np.asarray(cand_ids)[None],
        mesh=mesh).lane(0)


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
    "CandidateCacheConfig", "ShardedCandidateCache",
    "build_sharded_candidate_cache", "shard_candidate_cache",
    "densify_candidate_cache", "params_key", "build_candidate_cache",
    "keygen", "encrypt_query",
    "decrypt_scores", "decrypt_scores_batch", "decrypt_rns",
    "extract_scores", "pack_candidates", "pack_candidates_batch",
    "encrypted_scores", "encrypted_scores_batch",
    "encrypted_scores_batch_stacked", "encrypted_scores_cached",
    "encrypted_scores_cached_batch", "cosine_distances",
]
