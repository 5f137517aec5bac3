"""Public NTT API: the CUDA kernel for CUDA tensors, the plain PyTorch
version for CPU tensors.

Counterpart of ``repro/kernels/ntt/ops.py``; its ``use_pallas`` switch
becomes the tensor's device.  A kernel that fails to build or launch
raises — there is no switch that hides it behind the plain version.
"""

from __future__ import annotations

import math

import torch

from repro_torch.crypto.modring import PrimeCtx, shoup_quotients
from repro_torch.kernels.ext import on_cuda
from repro_torch.kernels.ntt import fused as _fused
from repro_torch.kernels.ntt import ntt as _kern
from repro_torch.kernels.ntt import ref as _ref


def ntt_fwd(x: torch.Tensor, ctx: PrimeCtx) -> torch.Tensor:
    """Forward negacyclic NTT, (..., N) int32 in [0, q) -> bit-rev NTT domain."""
    if not on_cuda(x):
        return _ref.ntt_fwd_ref(x, ctx)
    flat = x.to(torch.int32).reshape(-1, ctx.n).contiguous()
    return _kern.ntt_cuda(flat, ctx, inverse=False).reshape(x.shape)


def ntt_inv(x: torch.Tensor, ctx: PrimeCtx) -> torch.Tensor:
    """Inverse negacyclic NTT, bit-rev NTT domain -> coefficient domain."""
    if not on_cuda(x):
        return _ref.ntt_inv_ref(x, ctx)
    flat = x.to(torch.int32).reshape(-1, ctx.n).contiguous()
    return _kern.ntt_cuda(flat, ctx, inverse=True).reshape(x.shape)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor,
                  ctx: PrimeCtx) -> torch.Tensor:
    """Hadamard modular product in the NTT domain; ``b`` broadcasts to a's
    shape (the kernel reads an expanded ``b`` in place)."""
    if not on_cuda(a):
        return _ref.pointwise_mul_ref(a, b, ctx)
    a = a.to(torch.int32).contiguous()
    b = b.to(torch.int32).expand(a.shape)
    if b.shape[-1] > 1 and b.stride(-1) != 1:
        b = b.contiguous()
    return _kern.pointwise_mul_cuda(a, b, ctx)


def _key_count(lead: tuple, key_lead: tuple) -> int:
    """Keys ``key_lead`` (a prefix of a's leading dims ``lead``, then 1s)
    -> their number K: row r of the flattened a takes key r // (R // K)."""
    k = len(key_lead)
    while k and key_lead[k - 1] == 1:
        k -= 1
    if len(key_lead) > len(lead) or tuple(key_lead[:k]) != tuple(lead[:k]):
        raise ValueError(f"keys with leading shape {tuple(key_lead)} do not "
                         f"broadcast over a's leading shape {tuple(lead)} as "
                         f"a prefix followed by 1s")
    return math.prod(lead[:k])


def key_mul(a: torch.Tensor, s_hat: torch.Tensor, ctxs) -> torch.Tensor:
    """The RLWE key product iNTT_p(NTT_p(a[..., p, :]) * s_hat[..., p, :])
    for every prime p: a (..., P, N) coefficient-domain residues; s_hat
    NTT-domain keys, (P, N) for one key or one key per leading index of a,
    e.g. (B, 1, P, N) per-tenant keys over a (B, num_ct, P, N).  Returns
    (..., P, N) int32.

    On CUDA tensors one launch covers every prime and row, reading ``a``
    in place where its leading dims flatten to one stride; on the CPU the
    plain version runs the per-prime chain."""
    keys = _key_count(tuple(a.shape[:-2]), tuple(s_hat.shape[:-2]))
    if not on_cuda(a):
        return _ref.key_mul_ref(a, s_hat, ctxs)
    p, n = a.shape[-2:]
    a3 = a.to(torch.int32).reshape(-1, p, n)
    if n > 1 and a3.stride(-1) != 1:
        a3 = a3.contiguous()
    s3 = s_hat.to(torch.int32).reshape(keys, p, n).contiguous()
    return _kern.key_mul_cuda(a3, s3, ctxs).reshape(a.shape)


def fused_rotate_hadamard(polys, tw, f0, f1, ctx: PrimeCtx):
    """Cached re-rank core for one prime: slot twiddle rotate -> Hadamard
    against both query components -> slot/chunk mod-sum, NTT domain.

    polys: (B, num_ct, cpt*chunks, N) slot-major gathered cache rows;
    tw: (cpt, N); f0/f1: (B, chunks, N).  Returns (acc0, acc1), each
    (B, num_ct, N).  Followed by `ntt_inv` it equals
    `fused_rotate_hadamard_intt` bit for bit (the staged witness)."""
    if not on_cuda(polys):
        return _ref.fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx)
    tw = tw.contiguous()
    return _fused.fused_rerank_cuda(
        polys.contiguous(), tw, shoup_quotients(tw, ctx.q), f0.contiguous(),
        f1.contiguous(), ctx)


def fused_rotate_hadamard_intt(polys, tw, f0, f1, ctx: PrimeCtx):
    """Cached re-rank core for one prime with the inverse NTT absorbed:
    slot twiddle rotate -> Hadamard against both query components ->
    slot/chunk mod-sum -> inverse NTT.

    polys: (B, num_ct, cpt*chunks, N) slot-major gathered cache rows;
    tw: (cpt, N); f0/f1: (B, chunks, N).  Returns (acc0, acc1), each
    (B, num_ct, N), coefficient domain — bit-identical to the staged
    rotate/Hadamard + `ntt_inv` pipeline."""
    if not on_cuda(polys):
        return _ref.fused_rotate_hadamard_intt_ref(polys, tw, f0, f1, ctx)
    tw = tw.contiguous()
    return _fused.fused_rerank_intt_cuda(
        polys.contiguous(), tw, shoup_quotients(tw, ctx.q), f0.contiguous(),
        f1.contiguous(), ctx)


def fused_rotate_hadamard_intt_gathered(g, prime: int, num_cands: int, tw,
                                        tw_shoup, f0, f1, ctx: PrimeCtx):
    """`fused_rotate_hadamard_intt` on the gathered cache rows as the gather
    produced them: g (B, nc, chunks, P, N), read at prime index ``prime``;
    the candidates are ``g[:, :num_cands]`` in result-ciphertext order, cpt
    = ``tw.shape[0]`` to a ciphertext, and the last ciphertext's empty
    slots contribute nothing.  ``tw_shoup``: the twiddles' Shoup quotients
    (the cache's ``twiddles_shoup[prime]``; the kernel's rotate reads them,
    the plain version does not).
    Returns (acc0, acc1), each (B, ceil(num_cands / cpt), N).

    On a CUDA tensor the kernel reads ``g`` in place (no pad, no per-prime
    copy); on the CPU the plain version pads and reshapes."""
    if not on_cuda(g):
        return _ref.fused_rotate_hadamard_intt_gathered_ref(
            g, prime, num_cands, tw, f0, f1, ctx)
    return _fused.fused_rerank_intt_gathered_cuda(
        g, prime, num_cands, tw.contiguous(), tw_shoup.contiguous(),
        f0.contiguous(), f1.contiguous(), ctx)


def negacyclic_mul(a, b, ctx: PrimeCtx):
    """a * b in Z_q[X]/(X^N + 1)."""
    return ntt_inv(pointwise_mul(ntt_fwd(a, ctx), ntt_fwd(b, ctx), ctx), ctx)


__all__ = ["ntt_fwd", "ntt_inv", "pointwise_mul", "key_mul",
           "fused_rotate_hadamard",
           "fused_rotate_hadamard_intt",
           "fused_rotate_hadamard_intt_gathered", "negacyclic_mul"]
