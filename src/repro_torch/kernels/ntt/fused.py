"""Wrappers of the fused cached re-rank kernels (``csrc/fused.cu``).

Counterparts of ``repro/kernels/ntt/fused.py``:

  * `fused_rerank_intt_cuda`  <- ``fused_rerank_intt_pallas``: rotate ->
    Hadamard(c0, c1) -> slot/chunk mod-sum -> inverse NTT for one prime in
    one kernel (the serving path);
  * `fused_rerank_cuda`       <- ``fused_rerank_pallas``: the same sum with
    the NTT-domain accumulators out (the staged variant; followed by the
    standalone inverse NTT it equals the fused kernel bit for bit).

One block per (lane, result ciphertext).  CUDA tensors only;
`repro_torch.kernels.ntt.ops` routes CPU tensors to the plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels import ext


def fused_rerank_intt_cuda(polys: torch.Tensor, tw: torch.Tensor,
                           f0: torch.Tensor, f1: torch.Tensor,
                           ctx: PrimeCtx) -> tuple:
    """polys: (B, num_ct, cpt*chunks, N) gathered cache rows, slot-major;
    tw: (cpt, N) monomial twiddles; f0/f1: (B, chunks, N) query NTTs, all
    contiguous int32, with rows * (q - 1) < 2^31 (the binding checks).
    Returns (acc0, acc1), each (B, num_ct, N) int32, coefficient domain."""
    ext.require_cuda(polys, tw, f0, f1)
    out0, out1 = ext.extension().fused_rerank_intt(
        polys, tw, f0, f1, ctx.table("ipsi", polys.device), ctx.q,
        ctx.barrett64, ctx.n_inv)
    ext.count_launch("fused_rerank_intt")
    return out0, out1


def fused_rerank_cuda(polys: torch.Tensor, tw: torch.Tensor,
                      f0: torch.Tensor, f1: torch.Tensor,
                      ctx: PrimeCtx) -> tuple:
    """Same inputs as `fused_rerank_intt_cuda`; returns (acc0, acc1), each
    (B, num_ct, N) int32 in [0, q), NTT domain."""
    ext.require_cuda(polys, tw, f0, f1)
    out0, out1 = ext.extension().fused_rerank(polys, tw, f0, f1, ctx.q,
                                              ctx.barrett64)
    ext.count_launch("fused_rerank")
    return out0, out1


__all__ = ["fused_rerank_intt_cuda", "fused_rerank_cuda"]
