"""Wrappers of the hand-written CUDA NTT kernels (``csrc/ntt.cu``).

Counterpart of ``repro/kernels/ntt/ntt.py`` (``ntt_pallas``,
``pointwise_mul_pallas``), plus `key_mul_cuda`, the chain of the two that
the reference's ``encrypt_query`` and ``decrypt_rns`` run prime by prime,
fused over every prime into one launch.  These functions take CUDA tensors
only and always launch the kernel; `repro_torch.kernels.ntt.ops` picks them
for CUDA tensors and the plain versions in ``ref.py`` for CPU tensors.  The
binding (``csrc/bindings.cpp``) checks shapes, types and layout.
"""

from __future__ import annotations

import torch

from repro_torch.crypto import modring
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels import ext


def ntt_cuda(x: torch.Tensor, ctx: PrimeCtx, *,
             inverse: bool = False) -> torch.Tensor:
    """Batched (inverse) negacyclic NTT of contiguous (batch, N) int32 in
    [0, q)."""
    ext.require_cuda(x)
    kind = "ipsi" if inverse else "psi"
    out = ext.extension().ntt(x, ctx.table(kind, x.device),
                              ctx.table(kind + "_shoup", x.device), inverse,
                              ctx.q, *ctx.inv_tail)
    ext.count_launch("ntt_inv" if inverse else "ntt_fwd", x.shape)
    return out


def pointwise_mul_cuda(a: torch.Tensor, b: torch.Tensor,
                       ctx: PrimeCtx) -> torch.Tensor:
    """Elementwise (a * b) mod q: a contiguous int32; b int32 of a's shape
    with any leading strides (0 where it is broadcast, e.g. one key row
    ``expand``-ed over a batch: read in place, not copied) and unit stride
    in the last dim."""
    ext.require_cuda(a, b)
    out = ext.extension().pointwise_mul(a, b, ctx.q, ctx.barrett64)
    ext.count_launch("pointwise_mul",
                     (a.numel() // a.shape[-1], a.shape[-1]))   # as rows
    return out


def key_mul_cuda(a: torch.Tensor, s: torch.Tensor, ctxs) -> torch.Tensor:
    """out[r, p] = iNTT_p(NTT_p(a[r, p]) * s[r // (R // K), p]) mod q_p for
    every row r and prime p in one launch.

    a: (R, P, N) int32 in [0, q_p), unit stride in N, read in place through
    its row and prime strides; s: (K, P, N) contiguous int32 NTT-domain
    keys, K dividing R; ``ctxs``: the P primes' `PrimeCtx`.  Returns
    (R, P, N) contiguous int32, coefficient domain.  The launch is counted
    under "key_mul" at shape (R, P, N): (1, 3, 4096) is one encryption,
    (41, 3, 4096) one request's decryption, (328, 3, 4096) a batch of 8."""
    ext.require_cuda(a, s)
    t = modring.rns_tables(ctxs, a.device)
    out = ext.extension().key_mul(a, s, t.psi, t.psi_shoup, t.ipsi,
                                  t.ipsi_shoup, list(t.consts))
    ext.count_launch("key_mul", a.shape)
    return out


__all__ = ["ntt_cuda", "pointwise_mul_cuda", "key_mul_cuda"]
