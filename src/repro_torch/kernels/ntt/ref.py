"""Plain PyTorch negacyclic NTT: the CPU path and the kernels' oracle.

The same Longa-Naehrig merged-psi network as the reference
(``repro/kernels/ntt/ref.py``): Cooley-Tukey forward from standard to
bit-reversed order, Gentleman-Sande inverse back, with the same psi tables
and butterfly order, so NTT-domain tensors match the reference bit for bit
and not only after the inverse.  Arithmetic is int64; outputs are int32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto import modring
from repro_torch.crypto.modring import PrimeCtx


def ntt_fwd_ref(x: torch.Tensor, ctx: PrimeCtx) -> torch.Tensor:
    """Forward negacyclic NTT. x: (..., N) int in [0, q). Out bit-rev order."""
    n, q = ctx.n, ctx.q
    assert x.shape[-1] == n
    a = x.to(torch.int64)
    psi = ctx.table("psi", x.device).to(torch.int64)
    lead = tuple(a.shape[:-1])
    t, m = n, 1
    while m < n:
        t //= 2
        g = a.reshape(lead + (m, 2, t))
        s = psi[m: 2 * m].reshape((1,) * len(lead) + (m, 1))
        u = g[..., 0, :]
        v = modring.mod_mul(g[..., 1, :], s, q)
        a = torch.stack([modring.mod_add(u, v, q), modring.mod_sub(u, v, q)],
                        dim=-2).reshape(lead + (n,))
        m *= 2
    return a.to(torch.int32)


def ntt_inv_ref(x: torch.Tensor, ctx: PrimeCtx) -> torch.Tensor:
    """Inverse negacyclic NTT. Input bit-rev order, output standard order."""
    n, q = ctx.n, ctx.q
    assert x.shape[-1] == n
    a = x.to(torch.int64)
    ipsi = ctx.table("ipsi", x.device).to(torch.int64)
    lead = tuple(a.shape[:-1])
    t, m = 1, n
    while m > 1:
        h = m // 2
        g = a.reshape(lead + (h, 2, t))
        s = ipsi[h: 2 * h].reshape((1,) * len(lead) + (h, 1))
        u = g[..., 0, :]
        v = g[..., 1, :]
        a = torch.stack([modring.mod_add(u, v, q),
                         modring.mod_mul(modring.mod_sub(u, v, q), s, q)],
                        dim=-2).reshape(lead + (n,))
        t *= 2
        m = h
    return modring.mod_mul(a, ctx.n_inv, q).to(torch.int32)


def pointwise_mul_ref(a: torch.Tensor, b: torch.Tensor,
                      ctx: PrimeCtx) -> torch.Tensor:
    """Elementwise (a * b) mod q, int32 out."""
    return modring.mod_mul(a, b.to(torch.int64), ctx.q).to(torch.int32)


def key_mul_ref(a: torch.Tensor, s_hat: torch.Tensor, ctxs) -> torch.Tensor:
    """iNTT_p(NTT_p(a[..., p, :]) * s_hat[..., p, :]) for every prime p,
    prime by prime: a (..., P, N) int in [0, q_p); s_hat NTT-domain keys
    broadcasting against a's leading dims.  Returns (..., P, N) int32."""
    assert a.shape[-2] == len(ctxs), (a.shape, len(ctxs))
    return torch.stack([
        ntt_inv_ref(pointwise_mul_ref(ntt_fwd_ref(a[..., i, :], ctx),
                                      s_hat[..., i, :], ctx), ctx)
        for i, ctx in enumerate(ctxs)], dim=-2)


def fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx: PrimeCtx):
    """Rotate -> Hadamard(c0, c1) -> slot/chunk mod-sum, NTT domain.

    polys: (B, num_ct, cpt*chunks, N) slot-major; tw: (cpt, N);
    f0/f1: (B, chunks, N).  Returns (acc0, acc1), each (B, num_ct, N) int32.
    """
    bsz, num_ct, rows, n = polys.shape
    cpt, chunks = tw.shape[0], f0.shape[1]
    q = ctx.q
    g = polys.to(torch.int64).reshape(bsz, num_ct, cpt, chunks, n)
    rot = modring.mod_mul(g, tw.to(torch.int64)[None, None, :, None, :], q)
    p0 = modring.mod_mul(rot, f0.to(torch.int64)[:, None, None], q)
    p1 = modring.mod_mul(rot, f1.to(torch.int64)[:, None, None], q)
    acc0 = modring.mod_sum(p0.reshape(bsz, num_ct, rows, n), q, ctx.mu, axis=2)
    acc1 = modring.mod_sum(p1.reshape(bsz, num_ct, rows, n), q, ctx.mu, axis=2)
    return acc0.to(torch.int32), acc1.to(torch.int32)


def fused_rotate_hadamard_intt_ref(polys, tw, f0, f1, ctx: PrimeCtx):
    """`fused_rotate_hadamard_ref` followed by the inverse NTT of both
    accumulators (coefficient-domain result-ciphertext components)."""
    acc0, acc1 = fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx)
    return ntt_inv_ref(acc0, ctx), ntt_inv_ref(acc1, ctx)


def gathered_polys(g, prime: int, num_cands: int, cpt: int) -> torch.Tensor:
    """The (B, num_ct, cpt*chunks, N) slot-major rows of prime ``prime``
    from gathered cache rows g (B, nc, chunks, P, N): candidates at or
    past ``num_cands`` dropped, the last result ciphertext's empty slots
    zero-padded (a contiguous copy)."""
    bsz, _, chunks, _, n = g.shape
    rows = g[:, :num_cands, :, prime, :]
    pad = -(-num_cands // cpt) * cpt - num_cands
    if pad:
        rows = torch.cat([rows, rows.new_zeros((bsz, pad, chunks, n))], dim=1)
    return rows.reshape(bsz, -1, cpt * chunks, n).contiguous()


def fused_rotate_hadamard_intt_gathered_ref(g, prime: int, num_cands: int,
                                            tw, f0, f1, ctx: PrimeCtx):
    """`fused_rotate_hadamard_intt_ref` on `gathered_polys`."""
    return fused_rotate_hadamard_intt_ref(
        gathered_polys(g, prime, num_cands, tw.shape[0]), tw, f0, f1, ctx)


def negacyclic_mul_ref(a, b, ctx: PrimeCtx):
    """Negacyclic a*b in Z_q[X]/(X^N+1) via the plain NTT."""
    return ntt_inv_ref(pointwise_mul_ref(ntt_fwd_ref(a, ctx),
                                         ntt_fwd_ref(b, ctx), ctx), ctx)


def random_poly(rng: np.random.Generator, shape, q: int) -> np.ndarray:
    return rng.integers(0, q, size=shape, dtype=np.int64).astype(np.int32)


__all__ = ["ntt_fwd_ref", "ntt_inv_ref", "pointwise_mul_ref", "key_mul_ref",
           "fused_rotate_hadamard_ref", "fused_rotate_hadamard_intt_ref",
           "gathered_polys", "fused_rotate_hadamard_intt_gathered_ref",
           "negacyclic_mul_ref", "random_poly"]
