"""Wrappers of the fused cached re-rank kernels (``csrc/fused.cu``).

Counterparts of ``repro/kernels/ntt/fused.py``:

  * `fused_rerank_intt_gathered_cuda` <- ``fused_rerank_intt_pallas``:
    rotate -> Hadamard(c0, c1) -> slot/chunk mod-sum -> inverse NTT for one
    prime in one kernel, reading the gathered cache rows (B, nc, chunks, P,
    N) in place (the serving path);
  * `fused_rerank_intt_cuda`: the same kernel on a (B, num_ct, cpt*chunks,
    N) tensor, the reference's own layout;
  * `fused_rerank_cuda`            <- ``fused_rerank_pallas``: the same sum
    with the NTT-domain accumulators out (the staged variant; followed by
    the standalone inverse NTT it equals the fused kernel bit for bit).

``tw_shoup`` is the twiddles' Shoup quotient table, (cpt, N) like ``tw``
(the candidate caches' ``twiddles_shoup``, or
`repro_torch.crypto.modring.shoup_quotients`).  CUDA tensors only;
`repro_torch.kernels.ntt.ops` routes CPU tensors to the plain versions.
"""

from __future__ import annotations

import torch

from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels import ext


def _intt_consts(polys: torch.Tensor, ctx: PrimeCtx) -> tuple:
    return (ctx.table("ipsi", polys.device),
            ctx.table("ipsi_shoup", polys.device), ctx.q, ctx.barrett64,
            *ctx.inv_tail)


def fused_rerank_intt_gathered_cuda(
        g: torch.Tensor, prime: int, num_cands: int, tw: torch.Tensor,
        tw_shoup: torch.Tensor, f0: torch.Tensor, f1: torch.Tensor,
        ctx: PrimeCtx) -> tuple:
    """g: (B, nc, chunks, P, N) int32 gathered cache rows (unit stride in
    N; no copy is made), read at prime index ``prime``; candidates at or
    past ``num_cands`` contribute nothing.  tw/tw_shoup: (cpt, N) monomial
    twiddles and their Shoup quotients; f0/f1: (B, chunks, N) contiguous
    query NTTs.  Returns (acc0, acc1), each (B, ceil(num_cands / cpt), N)
    int32, coefficient domain."""
    ext.require_cuda(g, tw, tw_shoup, f0, f1)
    cpt = tw.shape[0]
    num_ct = -(-num_cands // cpt)
    out0, out1 = ext.extension().fused_rerank_intt_gathered(
        g, prime, num_cands, tw, tw_shoup, f0, f1, *_intt_consts(g, ctx))
    ext.count_launch("fused_rerank_intt",
                     (g.shape[0], num_ct, cpt * g.shape[2], g.shape[4]))
    return out0, out1


def fused_rerank_intt_cuda(polys: torch.Tensor, tw: torch.Tensor,
                           tw_shoup: torch.Tensor, f0: torch.Tensor,
                           f1: torch.Tensor, ctx: PrimeCtx) -> tuple:
    """polys: (B, num_ct, cpt*chunks, N) gathered cache rows, slot-major;
    tw/tw_shoup: (cpt, N) monomial twiddles and their Shoup quotients;
    f0/f1: (B, chunks, N) query NTTs, all contiguous int32, with
    rows * (q - 1) < 2^31 (the binding checks).  Returns (acc0, acc1), each
    (B, num_ct, N) int32, coefficient domain."""
    ext.require_cuda(polys, tw, tw_shoup, f0, f1)
    out0, out1 = ext.extension().fused_rerank_intt(
        polys, tw, tw_shoup, f0, f1, *_intt_consts(polys, ctx))
    ext.count_launch("fused_rerank_intt", polys.shape)
    return out0, out1


def fused_rerank_cuda(polys: torch.Tensor, tw: torch.Tensor,
                      tw_shoup: torch.Tensor, f0: torch.Tensor,
                      f1: torch.Tensor, ctx: PrimeCtx) -> tuple:
    """Same inputs as `fused_rerank_intt_cuda`; returns (acc0, acc1), each
    (B, num_ct, N) int32 in [0, q), NTT domain."""
    ext.require_cuda(polys, tw, tw_shoup, f0, f1)
    out0, out1 = ext.extension().fused_rerank(
        polys, tw, tw_shoup, f0, f1, ctx.q, ctx.barrett64)
    ext.count_launch("fused_rerank", polys.shape)
    return out0, out1


__all__ = ["fused_rerank_intt_gathered_cuda", "fused_rerank_intt_cuda",
           "fused_rerank_cuda"]
