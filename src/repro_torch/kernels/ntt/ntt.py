"""Wrappers of the hand-written CUDA NTT kernels (``csrc/ntt.cu``).

Counterpart of ``repro/kernels/ntt/ntt.py`` (``ntt_pallas``,
``pointwise_mul_pallas``).  These functions take CUDA tensors only and
always launch the kernel; `repro_torch.kernels.ntt.ops` picks them for
CUDA tensors and the plain versions in ``ref.py`` for CPU tensors.  The
binding (``csrc/bindings.cpp``) checks shapes, types and layout.
"""

from __future__ import annotations

import torch

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
    """Elementwise (a * b) mod q of two contiguous same-shape int32
    tensors."""
    ext.require_cuda(a, b)
    out = ext.extension().pointwise_mul(a, b, ctx.q, ctx.barrett64)
    ext.count_launch("pointwise_mul",
                     (a.numel() // a.shape[-1], a.shape[-1]))   # as rows
    return out


__all__ = ["ntt_cuda", "pointwise_mul_cuda"]
