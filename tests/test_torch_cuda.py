"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips.
The port's card checks are this file and the other ``test_torch_cuda_*.py``
files; run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda*.py \
        tests/test_torch_deepseek_v2.py

These files import torch and numpy only (no JAX), so they run where the
JAX package is not installed.
"""

import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.crypto import modring
from repro_torch.crypto import rlwe
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels import ext
from repro_torch.kernels.ntt import fused as kfused
from repro_torch.kernels.ntt import ntt as kntt
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.ntt import ref as nref
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.kernels.scoretopk import ref as sref
from repro_torch.kernels.scoretopk import scoretopk as kscore

pytestmark = pytest.mark.cuda


def _assert_ids_equal_up_to_ties(got, want, q, e, rtol=1e-5, atol=1e-6):
    """got/want: (..., B, k) ids for queries q (B, n) over rows e.  Kernel
    and plain version sum float32 products in different orders, so two rows
    whose exact scores lie within the value tolerance may come out in
    either order."""
    for pos in zip(*np.nonzero((got != want).numpy())):
        b = pos[-2]
        s_got = float(e[int(got[pos])].double() @ q[b].double())
        s_want = float(e[int(want[pos])].double() @ q[b].double())
        assert abs(s_got - s_want) <= atol + rtol * abs(s_want), (
            pos, s_got, s_want)


def _assert_exact_ties_by_id(v, i):
    """Equal finite scores come in ascending id order."""
    same = (v[..., 1:] == v[..., :-1]) & torch.isfinite(v[..., 1:])
    assert bool((i[..., 1:] > i[..., :-1])[same].all())


def _ctxs(n):
    # three primes below 2^20; at N = 16384 only two lie above 2^19
    return [PrimeCtx.build(q, n)
            for q in modring.find_ntt_primes(2 * n, 3, lo=1 << 16)]


# the grid, then the RLWE ring's rows (N = 4096 holds its three primes):
# the batch's 8 query rows, the two-tower round's 1,699 ciphertexts and a
# 4,096-row block
@pytest.mark.parametrize("n,batch", [(256, 1), (1024, 8), (4096, 5)] + [
    (n, batch) for n in (256, 1024, 4096, 16384) for batch in (1, 41, 328)]
    + [(4096, 8), (4096, 1699), (4096, 4096)])
def test_ntt_kernels_bit_identical(cuda, n, batch):
    rng = np.random.default_rng(n + batch)
    for ctx in _ctxs(n):
        x = torch.from_numpy(nref.random_poly(rng, (batch, n), ctx.q))
        y = torch.from_numpy(nref.random_poly(rng, (batch, n), ctx.q))
        xc, yc = x.to(cuda), y.to(cuda)
        assert torch.equal(ntt_ops.ntt_fwd(xc, ctx).cpu(), nref.ntt_fwd_ref(x, ctx))
        assert torch.equal(ntt_ops.ntt_inv(xc, ctx).cpu(), nref.ntt_inv_ref(x, ctx))
        assert torch.equal(ntt_ops.pointwise_mul(xc, yc, ctx).cpu(),
                           nref.pointwise_mul_ref(x, y, ctx))
        want = modring.negacyclic_mul_np(x.numpy()[:1], y.numpy()[:1], ctx.q) \
            if n <= 256 else None
        if want is not None:
            got = ntt_ops.negacyclic_mul(xc[:1], yc[:1], ctx).cpu().numpy()
            np.testing.assert_array_equal(got, want)


# (N, B, num_ct, keys): N = 2 (the smallest ring, 2-word vectors), 16 and
# 256 (256 and 16 polynomials a block: 41 rows straddle blocks), batch 0,
# one encryption, one request's decryption, the batch of 8 with tenant
# keys, and the large rings (512 and 1024 threads a block)
KEY_MUL_CASES = [(2, 1, 41, "one"), (2, 3, 41, "tenant"),
                 (16, 2, 41, "tenant"), (256, 3, 41, "tenant"),
                 (256, 0, 41, "tenant"), (256, 5, 1, "tenant"),
                 (4096, 1, 1, "one"), (4096, 1, 41, "one"),
                 (4096, 8, 41, "tenant"), (8192, 1, 5, "one"),
                 (16384, 1, 1, "one"), (16384, 2, 3, "tenant"),
                 (4096, 1, 1699, "one")]         # the two-tower round's


@pytest.mark.parametrize("n,bsz,num_ct,keys", KEY_MUL_CASES)
def test_key_mul_kernel_bit_identical(cuda, n, bsz, num_ct, keys):
    """The key product on every prime equals its plain version and the
    three standalone kernels chained prime by prime; ``a`` is read in place
    both contiguous and prime-major (strided, as encryption draws it)."""
    ctxs = _ctxs(n)
    rng = np.random.default_rng(n + 7 * bsz + num_ct)
    a = np.stack([nref.random_poly(rng, (bsz, num_ct, n), c.q)
                  for c in ctxs])                       # (P, B, num_ct, N)
    s = np.stack([nref.random_poly(rng, (bsz, 1, n) if keys == "tenant"
                                   else (n,), c.q) for c in ctxs], axis=-2)
    at = torch.from_numpy(a).permute(1, 2, 0, 3)
    st = torch.from_numpy(s)
    want = nref.key_mul_ref(at, st, ctxs)
    strided = at.to(cuda)
    assert not strided.is_contiguous() or bsz * num_ct <= 1
    for x in (strided, at.contiguous().to(cuda)):
        got = ntt_ops.key_mul(x, st.to(cuda), ctxs)
        assert got.shape == want.shape
        assert torch.equal(got.cpu(), want)
    if bsz == 0:
        return
    xc, sc = at.contiguous().to(cuda), st.to(cuda)
    for i, c in enumerate(ctxs):
        chain = ntt_ops.ntt_inv(ntt_ops.pointwise_mul(
            ntt_ops.ntt_fwd(xc[..., i, :], c), sc[..., i, :], c), c)
        assert torch.equal(got[..., i, :], chain)


def test_decrypt_scores_on_card_equal_host_extraction(cuda):
    """At the two-tower round's shape (8 lanes x 1,699 ciphertexts, width
    256, k' = 6,795, per-tenant keys) on uniform residues: decryption on
    the card down to the scores (gather and int64 CRT lift) equals
    `extract_scores` on the host copy of d, lane by lane, and copies only
    the scores."""
    from repro_torch import obs

    params = rlwe.RlweParams()
    sks = [rlwe.keygen(params, np.random.default_rng(i), device=cuda)
           for i in range(8)]
    n_dim, kprime = 256, 6795
    num_ct = -(-kprime // params.cands_per_ct(n_dim))
    assert num_ct == 1699
    g = torch.Generator(device=cuda).manual_seed(27)

    def uniform():
        return torch.stack([
            torch.randint(0, q, (8, num_ct, params.n_poly), generator=g,
                          device=cuda, dtype=torch.int32)
            for q in params.primes], dim=2)

    c0, c1 = uniform(), uniform()
    tracer = obs.Tracer()
    got = rlwe.decrypt_scores_batch(sks, rlwe.ScoreCiphertextBatch(
        c0=c0, c1=c1, n_dim=n_dim, num_cands=kprime), tracer=tracer)
    for b, sk in enumerate(sks):
        want = rlwe.extract_scores(
            params, rlwe.decrypt_rns(params, sk.s_ntt, c0[b], c1[b]),
            n_dim, kprime)
        np.testing.assert_array_equal(got[b], want)
    (copy,) = [s for s in tracer.spans() if s.name == "decrypt_copy"]
    assert copy.attrs == {"lanes": 8, "bytes": 8 * kprime * 8}


# (a's shape, b): b one row expanded (over the batch's, a request's, one
# and the two-tower round's rows), full, expanded over the middle dim
# (three collapsed dims), a transposed view (two unmergeable dims), and
# rows of 7 and 2 residues (4- and 8-byte vectors)
POINTWISE_CASES = [((328, 4096), "row"), ((41, 4096), "full"),
                   ((1, 4096), "row"), ((41, 4096), "row"),
                   ((1699, 4096), "row"),
                   ((8, 41, 4, 4096), "middle"),
                   ((6, 5, 8), "transposed"), ((5, 7), "row"),
                   ((3, 2), "full")]


@pytest.mark.parametrize("shape,kind", POINTWISE_CASES)
def test_pointwise_broadcast_kernel_bit_identical(cuda, shape, kind):
    n = shape[-1]
    rng = np.random.default_rng(sum(shape))
    for q in modring.find_ntt_primes(2 * max(n, 2), 3, lo=1 << 16):
        ctx = types.SimpleNamespace(q=q, barrett64=(1 << 64) // q)
        a = torch.from_numpy(nref.random_poly(rng, shape, q))
        if kind == "row":
            b = torch.from_numpy(nref.random_poly(rng, (n,), q)).expand(shape)
        elif kind == "middle":
            b = torch.from_numpy(nref.random_poly(
                rng, (shape[0],) + shape[2:], q))[:, None].expand(shape)
        elif kind == "transposed":
            b = torch.from_numpy(nref.random_poly(
                rng, (shape[1], shape[0], n), q)).transpose(0, 1)
        else:
            b = torch.from_numpy(nref.random_poly(rng, shape, q))
        want = nref.pointwise_mul_ref(a, b, ctx)
        got = kntt.pointwise_mul_cuda(a.to(cuda), b.to(cuda), ctx)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(ntt_ops.pointwise_mul(a.to(cuda), b.to(cuda),
                                                 ctx).cpu(), want)


@pytest.mark.parametrize("bsz,num_ct,cpt,chunks,n",
                         [(1, 3, 2, 1, 1024), (3, 5, 1, 2, 1024),
                          (8, 41, 4, 1, 4096)])
def test_fused_kernel_bit_identical(cuda, bsz, num_ct, cpt, chunks, n):
    rng = np.random.default_rng(bsz * num_ct)
    for ctx in _ctxs(n):
        polys = torch.from_numpy(nref.random_poly(
            rng, (bsz, num_ct, cpt * chunks, n), ctx.q))
        tw = torch.from_numpy(nref.random_poly(rng, (cpt, n), ctx.q))
        f0 = torch.from_numpy(nref.random_poly(rng, (bsz, chunks, n), ctx.q))
        f1 = torch.from_numpy(nref.random_poly(rng, (bsz, chunks, n), ctx.q))
        want = nref.fused_rotate_hadamard_intt_ref(polys, tw, f0, f1, ctx)
        got = ntt_ops.fused_rotate_hadamard_intt(
            polys.to(cuda), tw.to(cuda), f0.to(cuda), f1.to(cuda), ctx)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("bsz,num_ct,cpt,chunks,n",
                         [(1, 1, 1, 1, 256), (2, 3, 2, 1, 1024),
                          (3, 5, 1, 2, 1024), (8, 41, 4, 1, 4096)])
def test_fused_rerank_kernel_bit_identical(cuda, bsz, num_ct, cpt, chunks, n):
    """The staged kernel (NTT-domain accumulators out) against its plain
    version, and staged + standalone inverse NTT against the fused-iNTT
    kernel (the staged witness of the sharded-cache suite)."""
    rng = np.random.default_rng(7 * bsz + num_ct)
    for ctx in _ctxs(n):
        polys = torch.from_numpy(nref.random_poly(
            rng, (bsz, num_ct, cpt * chunks, n), ctx.q))
        tw = torch.from_numpy(nref.random_poly(rng, (cpt, n), ctx.q))
        f0 = torch.from_numpy(nref.random_poly(rng, (bsz, chunks, n), ctx.q))
        f1 = torch.from_numpy(nref.random_poly(rng, (bsz, chunks, n), ctx.q))
        args = [t.to(cuda) for t in (polys, tw, f0, f1)]
        want = nref.fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx)
        got = ntt_ops.fused_rotate_hadamard(*args, ctx)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        fused = ntt_ops.fused_rotate_hadamard_intt(*args, ctx)
        for staged, f in zip(got, fused):
            assert torch.equal(ntt_ops.ntt_inv(staged, ctx), f)


def _gathered(rng, bsz, nc, chunks, ctxs, n, value=None):
    """Gathered cache rows (B, nc, chunks, P, N): each prime's slice holds
    residues of that prime (all ``value`` if given, e.g. q - 1)."""
    g = np.empty((bsz, nc, chunks, len(ctxs), n), np.int32)
    for i, c in enumerate(ctxs):
        g[..., i, :] = (nref.random_poly(rng, (bsz, nc, chunks, n), c.q)
                        if value is None else value(c))
    return torch.from_numpy(g)


def _query_rows(rng, ctx, cpt, bsz, chunks, n, value=None):
    """tw (cpt, N), f0/f1 (B, chunks, N) residues of ctx's prime."""
    def draw(shape):
        if value is not None:
            return torch.full(shape, value(ctx), dtype=torch.int32)
        return torch.from_numpy(nref.random_poly(rng, shape, ctx.q))
    return draw((cpt, n)), draw((bsz, chunks, n)), draw((bsz, chunks, n))


# the main path's shapes (8 and 1 lanes, 41 result ciphertexts) at every N
# the kernel has a network for, with num_cands not a multiple of cpt; then
# the two-tower round's (k' = 6,795 at width 256: 1,699 ciphertexts)
@pytest.mark.parametrize("n,cpt,chunks,nc", [
    (n, c, k, 40 * c + 1) for n in (256, 1024, 4096, 16384)
    for c in (1, 2, 4) for k in (1, 2)] + [(4096, 4, 1, 6795)])
def test_fused_gathered_kernel_bit_identical(cuda, n, cpt, chunks, nc):
    """The fused kernel reading the gathered rows in place (strided, one
    prime of P) against its plain version (pad + reshape + the plain fused
    path), on every prime; the staged kernel + the standalone inverse NTT
    equals it."""
    rng = np.random.default_rng(n + 10 * cpt + chunks)
    ctxs = _ctxs(n)
    for bsz in (8, 1):
        g = _gathered(rng, bsz, nc, chunks, ctxs, n).to(cuda)
        for i, ctx in enumerate(ctxs):
            tw, f0, f1 = (t.to(cuda) for t in _query_rows(
                rng, ctx, cpt, bsz, chunks, n))
            want = nref.fused_rotate_hadamard_intt_gathered_ref(
                g, i, nc, tw, f0, f1, ctx)
            got = ntt_ops.fused_rotate_hadamard_intt_gathered(
                g, i, nc, tw, modring.shoup_quotients(tw, ctx.q), f0, f1,
                ctx)
            assert got[0].shape == (bsz, -(-nc // cpt), n)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            polys = nref.gathered_polys(g, i, nc, cpt)
            staged = ntt_ops.fused_rotate_hadamard(polys, tw, f0, f1, ctx)
            for s, w in zip(staged, want):
                assert torch.equal(ntt_ops.ntt_inv(s, ctx), w)


def test_fused_kernel_worst_raw_sum(cuda):
    """Every residue q - 1: each term (q-1)^2 (q-1) mod q = q - 1, so the
    reference's raw sum reaches rows * (q - 1), the most the binding admits
    (< 2^31), and the kernel's slot sums their most, cpt * (q - 1)."""
    n = 1024
    ctxs = _ctxs(n)
    q = max(c.q for c in ctxs)
    cpt = 4
    chunks = ((1 << 31) - 1) // (q - 1) // cpt     # rows * (q - 1) < 2^31
    assert cpt * chunks * (q - 1) > (1 << 31) - 4 * (q - 1)
    g = _gathered(None, 1, cpt, chunks, ctxs, n, value=lambda c: c.q - 1)
    g = g.to(cuda)
    for i, ctx in enumerate(ctxs):
        tw, f0, f1 = (t.to(cuda) for t in _query_rows(
            None, ctx, cpt, 1, chunks, n, value=lambda c: c.q - 1))
        want = nref.fused_rotate_hadamard_intt_gathered_ref(
            g, i, cpt, tw, f0, f1, ctx)
        tws = modring.shoup_quotients(tw, ctx.q)
        got = kfused.fused_rerank_intt_gathered_cuda(
            g, i, cpt, tw, tws, f0, f1, ctx)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        staged = kfused.fused_rerank_cuda(
            nref.gathered_polys(g, i, cpt, cpt), tw, tws, f0, f1, ctx)
        acc = cpt * chunks * (ctx.q - 1) % ctx.q
        assert bool((staged[0] == acc).all() and (staged[1] == acc).all())


def test_gathered_call_copies_no_rows(cuda):
    """The fused kernel reads g in place: one call allocates its two
    outputs and nothing of g's size; `_scores_pipeline` (the serving
    path) allocates its per-prime outputs and their stacks, and neither
    the zero pad of the last ciphertext nor a per-prime copy of g."""
    n, bsz, chunks, cpt, nc = 4096, 8, 2, 4, 161
    rng = np.random.default_rng(3)
    ctxs = [PrimeCtx.build(q, n) for q in modring.find_ntt_primes(2 * n, 3)]
    g = _gathered(rng, bsz, nc, chunks, ctxs, n).to(cuda)
    tw = torch.stack([_query_rows(rng, c, cpt, 1, 1, n)[0]
                      for c in ctxs]).to(cuda)
    cache = types.SimpleNamespace(
        twiddles=tw, twiddles_shoup=modring.shoup_quotients(
            tw, torch.tensor([c.q for c in ctxs], device=cuda).view(-1, 1, 1)))
    f = [_query_rows(rng, ctxs[0], cpt, bsz, chunks, n)[1].to(cuda)
         for _ in range(2)]
    out_bytes = 2 * bsz * 41 * n * 4                # one call's pair
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ntt_ops.fused_rotate_hadamard_intt_gathered(
        g, 0, nc, tw[0], cache.twiddles_shoup[0], f[0], f[1], ctxs[0])
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out_bytes + (1 << 20)
    del got
    c0 = torch.stack([torch.from_numpy(nref.random_poly(
        rng, (bsz, chunks, n), c.q)) for c in ctxs], dim=2).to(cuda)
    c1 = torch.stack([torch.from_numpy(nref.random_poly(
        rng, (bsz, chunks, n), c.q)) for c in ctxs], dim=2).to(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rlwe._scores_pipeline(c0, c1, g, cache, ctxs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # the outputs (3 pairs) and their stacks (3 pairs again) + 4 MiB: a pad
    # copy of g (127 MB) or a per-prime copy (42 MB) would exceed it
    assert peak <= 2 * 3 * out_bytes + (4 << 20)
    want = [nref.fused_rotate_hadamard_intt_gathered_ref(
        g, i, nc, tw[i], ntt_ops.ntt_fwd(c0[:, :, i], c),
        ntt_ops.ntt_fwd(c1[:, :, i], c), c) for i, c in enumerate(ctxs)]
    for z in range(2):
        assert torch.equal(got[z], torch.stack([w[z] for w in want], dim=2))


_BAD_CALLS = r"""
import sys
import torch
from repro_torch.kernels import ext

m = ext.extension()
dev = torch.device("cuda")
i32 = dict(dtype=torch.int32, device=dev)
n, q, bar = 256, 7681, (1 << 64) // 7681
x = torch.zeros((2, n), **i32)
tab = torch.zeros((n,), **i32)
g = torch.zeros((1, 5, 1, 3, n), **i32)
tw = torch.zeros((2, n), **i32)
f = torch.zeros((1, 1, n), **i32)
polys = torch.zeros((1, 3, 2, n), **i32)
# contiguous, but 4 bytes past a 16-byte boundary
skew = torch.zeros((1 + polys.numel(),), **i32)[1:].view(polys.shape)
tail = (1, 1, 1, 1)
a3 = torch.zeros((3, 3, n), **i32)
tab3 = torch.zeros((3, n), **i32)
consts = [q, bar, *tail] * 3
skew3 = torch.zeros((1 + a3.numel(),), **i32)[1:].view(a3.shape)
calls = {
    "ntt dtype": lambda: m.ntt(x.float(), tab, tab, False, q, *tail),
    "ntt table": lambda: m.ntt(x, tab[:7], tab, True, q, *tail),
    "ntt device": lambda: m.ntt(x.cpu(), tab, tab, False, q, *tail),
    "pointwise_mul shape": lambda: m.pointwise_mul(x, x[:1], q, bar),
    "pointwise_mul modulus": lambda: m.pointwise_mul(x, x, 1 << 21, bar),
    "pointwise_mul misaligned": lambda: m.pointwise_mul(
        skew[0, 0], skew[0, 0], q, bar),
    "key_mul primes": lambda: m.key_mul(
        a3, a3[:1], tab3[:2], tab3[:2], tab3[:2], tab3[:2], consts[:12]),
    "key_mul consts": lambda: m.key_mul(
        a3, a3[:1], tab3, tab3, tab3, tab3, consts[:12]),
    "key_mul misaligned": lambda: m.key_mul(
        skew3, a3[:1], tab3, tab3, tab3, tab3, consts),
    "key_mul keys": lambda: m.key_mul(
        a3, a3[:2], tab3, tab3, tab3, tab3, consts),
    "fused_rerank_intt rows": lambda: m.fused_rerank_intt(
        polys[:, :, :1].contiguous(), tw, tw, f, f, tab, tab, q, bar, *tail),
    "fused_rerank_intt misaligned": lambda: m.fused_rerank_intt(
        skew, tw, tw, f, f, tab, tab, q, bar, *tail),
    "fused_rerank_intt wrap": lambda: m.fused_rerank_intt(
        torch.zeros((1, 1, 2 * 300000, 4), **i32),
        torch.zeros((2, 4), **i32), torch.zeros((2, 4), **i32),
        torch.zeros((1, 300000, 4), **i32), torch.zeros((1, 300000, 4), **i32),
        tab[:4], tab[:4], 786433, bar, *tail),
    "fused_rerank_intt_gathered prime": lambda: m.fused_rerank_intt_gathered(
        g, 3, 5, tw, tw, f, f, tab, tab, q, bar, *tail),
    "fused_rerank_intt_gathered num_cands": lambda:
        m.fused_rerank_intt_gathered(
            g, 0, 6, tw, tw, f, f, tab, tab, q, bar, *tail),
    "fused_rerank_intt_gathered stride": lambda: m.fused_rerank_intt_gathered(
        torch.zeros((1, 5, 1, n, 3), **i32).transpose(3, 4), 0, 5, tw, tw,
        f, f, tab, tab, q, bar, *tail),
    "fused_rerank dims": lambda: m.fused_rerank(
        polys[0], tw, tw, f, f, q, bar),
    "fused_rerank query shape": lambda: m.fused_rerank(
        polys, tw, tw, f[..., :128], f, q, bar),
    "fused_rerank misaligned": lambda: m.fused_rerank(
        skew, tw, tw, f, f, q, bar),
    "score_topk kk": lambda: m.score_topk(
        torch.zeros((2, 64), device=dev), torch.zeros((100, 64), device=dev),
        300, 256),
    "score_topk dims": lambda: m.score_topk(
        torch.zeros((2, 64), device=dev), torch.zeros((100, 32), device=dev),
        8, 256),
}
for name, call in calls.items():
    try:
        call()
    except ValueError as e:
        print("ValueError", name, "|", e, flush=True)
    else:
        print("no error", name, flush=True)
        sys.exit(1)
"""


def test_binding_argument_errors_raise_value_error(cuda, tmp_path):
    """Every binding refuses a wrong shape, dtype, device or value with a
    ValueError whose message carries the numbers and shapes.  The calls
    run in a subprocess, so a crash while formatting a message fails this
    test instead of killing the test process."""
    ext.extension()                 # build here; the subprocess loads it
    script = tmp_path / "bad_calls.py"
    script.write_text(_BAD_CALLS)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ext.CSRC.parents[1])] + sys.path))
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, (r.returncode, r.stdout[-2000:],
                               r.stderr[-2000:])
    lines = r.stdout.splitlines()
    assert len(lines) == _BAD_CALLS.count('": lambda')
    assert all(line.startswith("ValueError") for line in lines)
    text = r.stdout
    for needle in ("(1, 5, 1, 3, 256)", "(2, 256) vs (1, 256)", "kk=300",
                   "2097152", "600000 rows", "num_cands 6", "prime 3",
                   "strides (3840, 768, 768, 1, 3)", "table has 7 entries",
                   "got a cpu tensor", "got shape (3, 2, 256)",
                   "with cpt 2 and chunks 1", "polys must have unit stride",
                   "16-byte aligned", "a and b must be 16-byte aligned",
                   "tables must be (P, N) = (3, 256)", "consts hold 12",
                   "a and s 16-byte aligned",
                   "keys of shape (2, 3, 256) do not broadcast"):
        assert needle in text, (needle, text)


def _tie_rows(rng, e, q, kk, tile):
    """300 rows of the first tile made copies of the row that ranks about
    50 places above the kk-th for query 0: exact ties straddling the kk-th
    place (identical rows score identically in the kernel)."""
    s = e[:tile] @ q[0]
    src = int(np.argsort(-s, kind="stable")[max(kk - 50, 0)])
    rows = rng.choice(np.delete(np.arange(tile), src), 300, replace=False)
    e[rows] = e[src]
    return np.sort(np.append(rows, src))


def _zero_rows(rng, q, e):
    """Queries zero in the second half of the dims; 20 rows above them, 300
    rows zero in the first half (each product +-0.0, so both the kernel and
    the plain version score them exactly +-0.0, equal), the rest below."""
    h = q.shape[1] // 2
    q[:, :h] = np.abs(q[:, :h])
    q[:, h:] = 0
    e[:, :h] = -np.abs(e[:, :h])
    e[:20, :h] *= -1
    zero = 20 + rng.choice(e.shape[0] - 20, 300, replace=False)
    e[zero, :h] = 0
    e[zero[::2], h:] *= -1


@pytest.mark.parametrize("b,n_rows,n,k,tile,special", [
    (1, 512, 128, 8, 256, None), (4, 1000, 384, 16, 256, None),
    (8, 300, 64, 300, 512, None), (2, 5000, 768, 161, 2048, None),
    (13, 5000, 768, 161, 2048, None),      # B > 8: two query groups
    (8, 3000, 768, 1, 2048, None),         # kk = 1
    (1, 4096, 768, 2048, 2048, None),      # kk = tile
    (8, 4500, 768, 161, 2048, "ties"), (1, 4500, 768, 161, 2048, "ties"),
    (8, 1000, 128, 64, 512, "zeros"),      # +-0.0 across the kk-th place
    (3, 2100, 128, 161, 2048, None),       # last tile: 52 rows < kk
    (5, 777, 130, 16, 256, None),          # dim % 4 != 0: 4-byte loads
    (1, 2**17, 256, 383, 2048, None),      # two-tower width: the round's
    (8, 20_000, 256, 161, 2048, None),     # corpus, the kernel rows' batch
    # the first stage's shapes at 10^6 x 768, k' = 161: the batch, one
    # request, the privacy-ignorant baseline's top 5; a 4-replica router's
    # slice, an IVF cluster of 16 and a 50,000-doc ingested tail; the text
    # corpus at k' = 1,058; Fig. 4's NN decode (8 radii x 50 queries) and
    # the attack over 100,000 aux documents (8 radii x 256 queries);
    # the two-tower first stage at width 256 (k' = 6,795, so kk = tile)
    (8, 10**6, 768, 161, 2048, None), (1, 10**6, 768, 161, 2048, None),
    (1, 10**6, 768, 5, 2048, None), (8, 250_000, 768, 161, 2048, None),
    (1, 62_500, 768, 161, 2048, None), (8, 62_500, 768, 161, 2048, None),
    (1, 50_000, 768, 161, 2048, None), (8, 50_000, 768, 161, 2048, None),
    (1, 2**17, 768, 1058, 2048, None), (8, 2**17, 768, 1058, 2048, None),
    (400, 3000, 768, 1, 2048, None), (2048, 100_000, 768, 1, 2048, None),
    (1, 2**17, 256, 2048, 2048, None), (1, 10**6, 256, 2048, 2048, None)])
def test_score_topk_kernel(cuda, b, n_rows, n, k, tile, special):
    rng = np.random.default_rng(n_rows)
    q = rng.normal(size=(b, n)).astype(np.float32)
    if n_rows * n > 1 << 26:       # float64 draws of 10^6 x 768 take ~25 s
        e = rng.standard_normal(size=(n_rows, n), dtype=np.float32)
    else:
        e = rng.normal(size=(n_rows, n)).astype(np.float32)
    if special == "zeros":
        _zero_rows(rng, q, e)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)      # unit-norm, as the
    e /= np.linalg.norm(e, axis=-1, keepdims=True)      # index stores them
    kk, t = min(k, tile, n_rows), min(tile, n_rows)
    tied = _tie_rows(rng, e, q, kk, t) if special == "ties" else None
    best = int(np.argmax(e @ q[0]))
    e[n_rows // 2] = e[best]                    # an exact tie in the top k
    e[n_rows - 1] = e[best]
    q, e = torch.from_numpy(q), torch.from_numpy(e)
    kv, ki = kscore.score_topk_cuda(q.to(cuda), e.to(cuda), kk=kk, tile=t)
    # the plain version on the CPU, or on the card where the CPU would take
    # minutes (8 queries over 10^6 x 768 are 6·10^9 products)
    ref = torch.device("cpu") if b * n_rows * n <= 1 << 30 else cuda
    pv, pi = sref.tile_topk_ref(q.to(ref), e.to(ref), kk, t)
    plain_v, plain_i = sref.merge_tiles_ref(pv, pi, min(k, n_rows))
    pv, pi = pv.cpu(), pi.cpu()
    torch.testing.assert_close(kv.cpu(), pv, rtol=1e-5, atol=1e-6)
    _assert_ids_equal_up_to_ties(ki.cpu(), pi, q, e)
    _assert_exact_ties_by_id(kv.cpu(), ki.cpu())
    if special == "zeros":                      # every tie is exact
        assert torch.equal(ki.cpu(), pi)
    if tied is not None:                        # the lowest tied rows win
        for row in ki[0].cpu().numpy():
            got = np.intersect1d(row, tied)
            np.testing.assert_array_equal(got, tied[:len(got)])
    got = sops.topk_scores(q.to(cuda), e.to(cuda), k, tile=tile)
    torch.testing.assert_close(got.values.cpu(), plain_v.cpu(), rtol=1e-5,
                               atol=1e-6)
    _assert_ids_equal_up_to_ties(got.indices.cpu(), plain_i.cpu(), q, e)
    if k > 1:
        assert float(got.values[0, 1]) == float(got.values[0, 0])  # the tie
    _assert_exact_ties_by_id(got.values.cpu(), got.indices.cpu())


@pytest.mark.parametrize("clustered", [False, True])
def test_certificate_at_tower_shape_stays_small(cuda, clustered):
    """The two-tower first stage's shape (8 lanes, k' = 6,795 > tile, so kk
    = tile): the certificate's answer equals the membership broadcast,
    taken here one lane at a time (~0.9 GB a lane), and the whole call
    stays within 256 MB above its inputs (the broadcast's transient was
    ~7.1 GB)."""
    b, n_rows, n, k, tile = 8, 2**17, 256, 6795, 2048
    g = torch.Generator(device=cuda).manual_seed(30)
    q = torch.randn((b, n), generator=g, device=cuda)
    e = torch.randn((n_rows, n), generator=g, device=cuda)
    if clustered:                       # lane 3's winners fill tile 5
        e[5 * tile:6 * tile] = q[3] + 0.01 * e[5 * tile:6 * tile]
    q /= q.norm(dim=-1, keepdim=True)
    e /= e.norm(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sops.topk_scores(q, e, k, tile=tile)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 256 << 20
    assert got.exact is not clustered
    vals, gidx = kscore.score_topk_cuda(q, e, kk=tile, tile=tile)
    _, mi = sref.merge_tiles_ref(vals, gidx, k)
    assert torch.equal(mi, got.indices)
    want = True
    for lane in range(b):
        member = (gidx[:, lane, :, None] == mi[lane]).any(-1)   # (T, kk)
        want &= bool(torch.all(member.sum(-1) < tile))
        del member
    assert got.exact == want


def test_sharded_gather_while_admission_in_flight(cuda):
    """Sharded gathers on the card equal the dense cache's device gather
    before, during (the admitter's copy held on its side stream) and after
    an admission, and across an eviction that frees a shard a gather just
    read (mirror of the reference's in-flight test)."""
    params = rlwe.RlweParams(n_poly=1024, chunk=512)
    rng = np.random.default_rng(5)
    docs = rng.normal(size=(64, 384)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    dense = rlwe.build_candidate_cache(params, torch.from_numpy(docs).to(cuda))
    one_shard = dense.nbytes // 4
    sh = rlwe.shard_candidate_cache(dense, rlwe.CandidateCacheConfig(
        shard_docs=16, admit_threshold=1, max_resident_bytes=one_shard))
    started, release = threading.Event(), threading.Event()

    def hook(_s):
        started.set()
        assert release.wait(30)
    sh._admit_hook = hook
    ids = rng.integers(0, 16, size=(3, 9))             # shard 0 only

    def want(i):
        return dense.polys[torch.from_numpy(i).to(cuda)]

    assert torch.equal(sh.gather(ids), want(ids))       # enqueues shard 0
    assert started.wait(30)
    assert torch.equal(sh.gather(ids), want(ids))       # streams meanwhile
    release.set()
    sh.flush()
    assert sh.resident_shards == (0,)
    got = sh.gather(ids)                                # device gather
    sh._admit_hook = None
    other = ids + 16                                    # shard 1 evicts 0
    sh.gather(other)
    sh.flush()
    assert sh.resident_shards == (1,) and sh.evictions == 1
    assert torch.equal(got, want(ids))
    assert torch.equal(sh.gather(other), want(other))
    torch.cuda.synchronize()


def test_launches_are_counted(cuda):
    ctx = _ctxs(256)[0]
    x = torch.zeros((2, 256), dtype=torch.int32, device=cuda)
    ext.reset_launches()
    ntt_ops.ntt_fwd(x, ctx)
    ntt_ops.ntt_fwd(x.cpu(), ctx)               # plain version: not counted
    ntt_ops.pointwise_mul(x, x[0], ctx)
    ctxs = _ctxs(256)
    a = torch.zeros((2, 5, 3, 256), dtype=torch.int32, device=cuda)
    ntt_ops.key_mul(a, a[:, :1], ctxs)          # all primes: one launch
    ntt_ops.key_mul(a.cpu(), a[:, :1].cpu(), ctxs)
    assert ext.launch_counts() == {"ntt_fwd": 1, "pointwise_mul": 1,
                                   "key_mul": 1}
    assert ext.launch_shapes()[("key_mul", (10, 3, 256))] == 1


def _kernel_scores(q, e, tile):
    """Every (query, row) score the kernel computes: per-tile top-kk with kk
    the whole tile, scattered back by row id (the -inf pad of a short last
    tile lands in an extra column)."""
    t = min(tile, e.shape[0])
    vals, idx = kscore.score_topk_cuda(q, e, kk=t, tile=t)
    out = torch.full((q.shape[0], e.shape[0] + 1), float("nan"),
                     device=q.device)
    lane = torch.arange(q.shape[0], device=q.device)[None, :, None]
    out[lane.expand_as(idx), idx.long()] = vals
    return out[:, :-1]


@pytest.mark.parametrize("n", [768, 64, 130, 6])
def test_slice_scores_bit_identical_to_full_scan(cuda, n):
    """A score's bits depend on its (query, row) pair alone: slices at odd
    starts, query subsets (other query groups), other tiles and a slice
    shorter than a tile score every pair exactly as the full scan does."""
    rng = np.random.default_rng(n)
    q = rng.normal(size=(13, n)).astype(np.float32)
    e = rng.normal(size=(3000, n)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    qc, ec = torch.from_numpy(q).to(cuda), torch.from_numpy(e).to(cuda)
    full = _kernel_scores(qc, ec, 256)
    assert not bool(full.isnan().any())
    for start, stop, tile in ((0, 3000, 2048), (1, 2999, 256),
                              (17, 1200, 512), (1001, 1101, 2048),
                              (2950, 3000, 256), (3, 4, 256)):
        for qsel in (list(range(13)), [3], [1, 5, 6], [0, 2, 4, 6, 8, 10]):
            got = _kernel_scores(qc[qsel], ec[start:stop], tile)
            want = full[qsel][:, start:stop]
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
                start, stop, tile, qsel)


def test_slice_merge_bit_identical_with_ties_across_cuts(cuda):
    """Twenty copies of query 0's best row spread over the corpus and k = 8:
    per-slice scans merged by (score desc, id asc) return the eight lowest
    copies and the full scan's value bits, whatever the cuts."""
    from repro_torch.retrieval.index import FlatIndex, plan_row_slices
    from repro_torch.retrieval.topk import distributed_topk, slice_topk
    from repro_torch.serve.router import merge_topk

    rng = np.random.default_rng(11)
    e = rng.normal(size=(6000, 768)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    q = e[rng.integers(0, 6000, size=8)] + 0.1 * rng.normal(size=(8, 768))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    best = int(np.argmax(e @ q[0]))
    copies = np.sort(rng.choice(6000, 19, replace=False))
    e[copies] = e[best]
    tied = np.sort(np.append(copies, best))
    index = FlatIndex.build(e, normalize=False, device=cuda)
    qc = torch.from_numpy(q).to(cuda)
    for k in (8, 161):
        full = distributed_topk(index, qc, k)
        if k == 8:
            assert full.indices[0].tolist() == tied[:8].tolist()
        for n_slices in (2, 3, 5):
            for cuts in (plan_row_slices(6000, n_slices),
                         [(0, 1), (1, 2049), (2049, 6000)]):
                parts = [slice_topk(index.slice_view(a, b), qc, k)
                         for a, b in cuts]
                merged = merge_topk([p.values.cpu().numpy() for p in parts],
                                    [p.indices.cpu().numpy() for p in parts],
                                    k)
                assert merged.tolist() == full.indices.cpu().tolist()


def _ivf_index(device, n_docs=600, dim=64, clusters=6, align=1):
    from repro_torch.data import synth as tsynth
    from repro_torch.retrieval.index import FlatIndex, IvfConfig

    rng = np.random.default_rng(0)
    emb = tsynth.uniform_corpus(rng, n_docs, dim)
    emb[n_docs * 3 // 4] = emb[10]
    emb[n_docs // 2] = emb[10]
    q = tsynth.queries_near_corpus(rng, emb, 6)
    q[2] = emb[10]
    docs = [f"passage-{i}".encode() for i in range(n_docs)]
    index = FlatIndex.build(emb, documents=docs, normalize=False,
                            ivf=IvfConfig(num_clusters=clusters,
                                          align=align), device=device)
    return index, q


def test_cluster_topk_equals_flat_scan_on_card(cuda):
    from repro_torch.retrieval.topk import cluster_topk, distributed_topk

    index, q = _ivf_index(cuda, n_docs=6000, dim=768, clusters=6, align=500)
    view = index.corpus_view()
    qc = torch.from_numpy(q).to(cuda)
    cpu_index, _ = _ivf_index("cpu", n_docs=6000, dim=768, clusters=6,
                              align=500)
    for k in (8, 161):
        flat = distributed_topk(index, qc, k)
        for nprobe in (None, 6, 9):
            routed = cluster_topk(view, qc, k, nprobe=nprobe)
            assert torch.equal(routed.indices, flat.indices)
            assert torch.equal(routed.values.view(torch.int32),
                               flat.values.view(torch.int32))
            assert routed.exact
        plain = cluster_topk(cpu_index.corpus_view(), q, k)
        torch.testing.assert_close(flat.values.cpu(), plain.values,
                                   rtol=1e-5, atol=1e-6)
        _assert_ids_equal_up_to_ties(flat.indices.cpu(), plain.indices,
                                     torch.from_numpy(q),
                                     cpu_index.embeddings)


def test_ingest_tail_on_card_equals_plain_pack(cuda):
    """Tail shards packed on the card (one longer, one shorter than
    shard_docs) equal the plain pack bit for bit; the admitter's pinned
    staging copies them to the card and gathers read them there."""
    params = rlwe.RlweParams(n_poly=1024, chunk=512)
    index, _ = _ivf_index(cuda)
    cfg = rlwe.CandidateCacheConfig(shard_docs=64, admit_threshold=1)
    sh = index.candidate_cache(params, cfg)
    rng = np.random.default_rng(3)
    tails = []
    for m in (100, 30):
        new = rng.normal(size=(m, 64)).astype(np.float32)
        new /= np.linalg.norm(new, axis=-1, keepdims=True)
        tails.append(new)
        index.ingest(new, normalize=False)
    sh.flush()
    assert sh.ingests == 2 and sh.num_docs == 730 and sh.epoch == 2
    assert set(sh.resident_shards) >= {sh.num_shards - 2, sh.num_shards - 1}
    plain = rlwe._pack_corpus_ntt(
        params, torch.from_numpy(np.concatenate(tails)), host=True)
    on_card = rlwe._pack_corpus_ntt(
        params, torch.from_numpy(np.concatenate(tails)).to(cuda))
    assert np.array_equal(on_card.cpu().numpy(), plain)
    ids = np.arange(600, 730).reshape(2, 65)
    assert torch.equal(sh.gather(ids).cpu(),
                       torch.from_numpy(plain).reshape(2, 65, *plain.shape[1:]))
    assert sh.stats()["hits"] > 0
    sh.close()


@pytest.mark.parametrize("ivf,replicas", [(False, 2), (True, 2), (False, 4)])
def test_router_two_replicas_equals_engine_on_card(cuda, ivf, replicas):
    """The router's scatter-gather over 2 (and 4) replicas equals one
    engine per request (ids, documents, wire bytes), with no fallback scan
    and no replica quarantined."""
    from repro_torch.data import synth as tsynth
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   ServeEngine, SessionManager)

    params = rlwe.RlweParams(n_poly=1024, chunk=512)
    if ivf:
        index, q = _ivf_index(cuda)
    else:
        rng = np.random.default_rng(1)
        emb = tsynth.uniform_corpus(rng, 1500, 64)
        emb[800] = emb[100]
        emb[1200] = emb[100]
        q = tsynth.queries_near_corpus(rng, emb, 8)
        q[3] = emb[100]
        index = FlatIndex.build(emb, normalize=False, device=cuda, documents=[
            f"passage-{i}".encode() for i in range(1500)])
    cfg = EngineConfig(max_batch=3, max_wait_s=30.0,
                       nprobe=6 if ivf else None)

    def run(srv):
        for t in ("alice", "bob"):
            srv.open_session(t, n=64, N=index.num_rows, k=4,
                             plan_kwargs={"kprime": 12})
        for i, x in enumerate(q):
            srv.submit(("alice", "bob")[i % 2], x, key=i)
        out = srv.drain()
        fleet = (srv.summary()["router"] if isinstance(srv, ReplicaRouter)
                 else None)
        srv.close()
        return out, fleet

    def sessions():
        return SessionManager(rlwe_params=params, deterministic_seeds=True,
                              device=cuda)

    want, _ = run(ServeEngine(index, config=cfg, sessions=sessions()))
    got, fleet = run(ReplicaRouter(index, config=RouterConfig(
        num_replicas=replicas, engine=cfg), sessions=sessions()))
    assert fleet["fallback_scans"] == 0 and not fleet["quarantines"], fleet
    assert len(got) == len(q) and all(r.ok for r in got)
    for a, b in zip(want, got):
        assert a.request_id == b.request_id and a.docs == b.docs
        assert a.ids.tolist() == b.ids.tolist()
        assert a.transcript.total_bytes == b.transcript.total_bytes


# -- the Paillier backend's bignum ops on the card ---------------------------


def _bignum_ctx(key_bits):
    """n^2 of a seeded Paillier key: 46 channels at 512 bits, the budget's
    64-channel edge at 726 bits."""
    from repro_torch.crypto import paillier as pai
    from repro_torch.kernels.bignum import ref as bref

    sk = pai.keygen(key_bits, rng=np.random.default_rng(key_bits))
    return bref.for_modulus(sk.pub.n_sq)


@pytest.mark.parametrize("key_bits,channels", [(512, 46), (726, 64)])
def test_bignum_ops_on_card_equal_cpu(cuda, key_bits, channels):
    """mont_mul, the windowed exponentiation and product_reduce on CUDA
    float64 tensors (cuBLAS matmuls) equal the CPU path bit for bit: every
    value is an exact integer below 2^53."""
    from repro_torch.kernels.bignum import ops as bops
    from repro_torch.kernels.bignum import ref as bref

    ctx = _bignum_ctx(key_bits)
    assert ctx.system.s == channels
    rng = np.random.default_rng(3)
    vals = [int(rng.integers(0, 2**62)) ** 20 % ctx.modulus
            for _ in range(3 * 40 * 9)]
    x = bref.to_rns(ctx, [bref.to_mont(ctx, v) for v in vals]).reshape(
        3, 40, 9, -1)
    outs = {}
    for dev in (torch.device("cpu"), cuda):
        C = bops.make_consts(ctx.system, [ctx] * 3, 3, device=dev)
        C2 = bops.make_consts(ctx.system, [ctx] * 3, 2, device=dev)
        t = torch.from_numpy(x).to(dev)
        a = t[:, :, 0]
        digits = torch.from_numpy(bops.to_digits(
            [ctx.modulus >> 3] * 120, 4).reshape(3, 40, -1)).to(dev)
        outs[dev.type] = (
            bops.mont_mul(t, t, C),
            bops.mont_exp_digits(bops.pow_table(a, C2, 4), digits, C2, 4),
            bops.product_reduce(t, C),
            bops.product_reduce(t[:, :, :5], C))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(got.cpu(), want)


# (lanes, dim, candidates): a small batch, then the score stage's shapes at
# the paper's point (8 lanes of 4 tenants' keys, 768 dims, k' = 161)
@pytest.mark.parametrize("lanes,dim,cands", [(3, 96, 17), (8, 768, 161)])
def test_paillier_scores_on_card_equal_object_path(cuda, lanes, dim, cands):
    """The vectorized Paillier encrypt, score and decrypt on the card equal
    the object path's integers under shared seeds, repeat bit for bit, and
    send no 512-bit lane to the object path."""
    from repro_torch.crypto import paillier as pai
    from repro_torch.crypto import paillier_vec as pvec

    keys = [pai.keygen(512, rng=np.random.default_rng(60 + i))
            for i in range(min(lanes, 4))]
    keys = [keys[i % len(keys)] for i in range(lanes)]
    rng = np.random.default_rng(61)
    q = rng.normal(size=(lanes, dim))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    cands = rng.normal(size=(lanes, cands, dim))
    cands /= np.linalg.norm(cands, axis=-1, keepdims=True)
    pvec.reset_counters()

    def encrypt(i):
        return pvec.encrypt_vector(keys[i].pub, q[i],
                                   rng=np.random.default_rng(70 + i),
                                   device=cuda)

    def score():
        return pvec.encrypted_scores_batch(
            [k.pub for k in keys], enc, [torch.from_numpy(c).to(cuda)
                                         for c in cands],
            rngs=[np.random.default_rng(80 + i) for i in range(lanes)],
            device=cuda)

    enc = [encrypt(i) for i in range(lanes)]
    assert encrypt(0) == enc[0]
    for i, (k, e) in enumerate(zip(keys, q)):
        assert enc[i] == pai.encrypt_vector(k.pub, e,
                                            rng=np.random.default_rng(70 + i))
    got = score()
    assert score() == got
    want = [pai.encrypted_scores(k.pub, e, c, rng=np.random.default_rng(80 + i))
            for i, (k, e, c) in enumerate(zip(keys, enc, cands))]
    assert got == want
    dec = pvec.decrypt_scores_batch(keys, got, device=cuda)
    assert pvec.counters["object"] == 0, pvec.counters
    for k, ct, d, c, e in zip(keys, got, dec, cands, q):
        np.testing.assert_array_equal(d, pai.decrypt_scores(k, ct))
        np.testing.assert_allclose(d, c @ e, rtol=0, atol=2e-3)


@pytest.mark.parametrize("n_docs,vocab,n_q", [(3000, 1024, 50),
                                              (100_000, 4096, 256)])
def test_nn_attack_top1_through_the_kernel(cuda, n_docs, vocab, n_q):
    """The NN attack's batched decode (score-top-k, kk = 1) on the card:
    launched through the kernel, and equal to the plain version up to
    score ties (rows within 1e-5 of each other may swap)."""
    from repro_torch.core import attacks
    from repro_torch.data import synth

    rng = np.random.default_rng(n_docs)
    corpus = synth.token_corpus(rng, n_docs, 768, vocab=vocab, doc_len=20,
                                paraphrases=15)
    obs = attacks.perturbed_queries(corpus, range(n_q), [0.0, 0.1, 1.0, 4.0],
                                    rng)
    atk = attacks.NearestNeighborAttack(aux=corpus, device=cuda)
    ext.reset_launches()
    got = atk.decode_indices(obs)
    assert ext.launch_counts() == {"score_topk": 1}
    q = torch.from_numpy(synth.unit(obs).astype(np.float32))
    _, want = sref.topk_ref(q.to(cuda), atk.embeddings, 1)
    _assert_ids_equal_up_to_ties(torch.from_numpy(got)[:, None], want.cpu(),
                                 q, torch.from_numpy(corpus.embeddings))
    assert (got[:n_q] == np.arange(n_q)).mean() > 0.9   # r = 0 finds itself


def test_embedder_on_card_equals_cpu(cuda):
    """The 768-wide, 4-layer encoder on the card against the same weights
    on the CPU (float32, TF32 off), within 1e-4."""
    from repro_torch.data.tokenizer import HashTokenizer
    from repro_torch.models.embedder import Embedder, encoder_config

    cfg = encoder_config(dim=768)
    cpu = Embedder(cfg, generator=torch.Generator().manual_seed(3),
                   device="cpu")
    card = Embedder(cfg, generator=torch.Generator().manual_seed(3),
                    device=cuda)
    texts = [f"topic {i} words w{i * 7 % 500} w{i * 13 % 500}"
             for i in range(64)]
    tokens = HashTokenizer(cfg.vocab).encode_batch(texts, 32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = card.embed(tokens).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want = cpu.embed(tokens)
    assert got.shape == (64, 768)
    assert float((got - want).abs().max()) <= 1e-4


# (width, prompts, prompt length, decode steps, cache length): the reduced
# config, then every published width with tp = 1 at 2 of the 48 layers
@pytest.mark.parametrize("width,prompts,length,steps,max_len",
                         [("reduced", 4, 24, 3, 32), ("full", 2, 64, 4, 68)])
def test_moe_lm_on_card_equals_cpu(cuda, width, prompts, length, steps,
                                   max_len):
    """Qwen3-MoE (float32, TF32 off) on the card against the same weights
    on the CPU: prefill of the prompts, then decode steps fed the CPU's
    greedy tokens.  Every layer's MoE runs once a call on both; routing
    ids equal wherever a token's k-th/(k+1)-th router-logit gap exceeds
    1e-4 on both devices; logits within 1e-3 on the sequences with no
    token below that gap; no kernel of ours launched."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels import ext
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import Transformer

    entry = registry.get("qwen3-moe-30b-a3b")
    cfg = entry.reduced if width == "reduced" else dataclasses.replace(
        entry.config, tp=1, n_layers=2, dtype="float32")
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(4),
                      device="cpu")
    card = Transformer(cfg, generator=torch.Generator(device=cuda)
                       .manual_seed(5), device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = np.random.default_rng(11).integers(0, cfg.vocab,
                                                size=(prompts, length))

    def run(model, feed):
        record = []

        def hook(mod, inputs, _out):
            _, values, ids = moe_lib.route(mod, inputs[0], mod.spec)
            k = mod.spec.top_k
            record.append((ids[..., :k].cpu(),
                           (values[..., k - 1] - values[..., k]).cpu()))

        hooks = [blk.moe.register_forward_hook(hook) for blk in model.layers]
        logits, cache = model.prefill(tokens, max_len=max_len)
        outs, fed = [logits.cpu()], []
        for step in range(steps):
            nxt = (outs[-1][:, -1, :cfg.vocab].argmax(-1) if feed is None
                   else feed[step])
            fed.append(nxt)
            lg, cache = model.decode_step(nxt[:, None], cache)
            outs.append(lg[:, None].cpu())
        for h in hooks:
            h.remove()
        return outs, record, fed

    want, rec_cpu, fed = run(cpu, None)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ext.reset_launches()
    try:
        got, rec_card, _ = run(card, fed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ext.launch_counts() == {}          # no kernel on the LM path
    assert len(rec_cpu) == len(rec_card) == cfg.n_layers * (1 + steps)
    excluded = torch.zeros(prompts, dtype=torch.bool)
    for (ids_a, gap_a), (ids_b, gap_b) in zip(rec_cpu, rec_card):
        clear = torch.minimum(gap_a, gap_b) > 1e-4
        excluded |= (~clear).any(dim=1)
        assert not ((ids_a != ids_b).any(-1) & clear).any()
    assert not excluded.all()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert float((g - w).abs()[~excluded].max()) <= 1e-3


def _router_gap(model, tokens) -> float:
    """Smallest k-th/(k+1)-th router-logit gap of a forward on ``tokens``
    (inf on a dense model)."""
    from repro_torch.models import moe as moe_lib

    gaps = []

    def hook(mod, inputs, _out):
        _, values, _ = moe_lib.route(mod, inputs[0], mod.spec)
        k = mod.spec.top_k
        gaps.append(float((values[..., k - 1] - values[..., k]).min()))

    hooks = [blk.moe.register_forward_hook(hook) for blk in model.layers
             if hasattr(blk, "moe")]
    with torch.no_grad():
        model.forward(tokens)
    for h in hooks:
        h.remove()
    return min(gaps, default=float("inf"))


def test_two_tower_round_on_card_equals_cpu(cuda):
    """``examples/recsys_retrieval.py``'s round at tower width 256 (a
    narrow two-tower: 32-wide embeddings, tower 64 -> 256), trained on the
    CPU and copied to the card: the same items, users and keys on both
    sides; recall@5 = 1.0 and the same ids and wire bytes on both (the
    perturbations differ: a CUDA generator draws other bits), decrypted
    scores within 2e-3 of the plaintext inner products, and every kernel
    of the serving path launched on the card's round (and no standalone
    inverse NTT, pointwise product or staged re-rank)."""
    from repro_torch.examples import recsys_retrieval as ex
    from repro_torch.models import recsys

    cfg = recsys.TwoTowerConfig(embed_dim=32, tower_mlp=(64, 256),
                                user_vocab=1000, item_vocab=1000,
                                n_user_feats=3, n_item_feats=2)
    cpu, _ = ex.train(cfg, steps=20, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = recsys.TwoTower(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    want = ex.retrieve(cpu, rng=np.random.default_rng(3))
    ext.reset_launches()
    got = ex.retrieve(card, rng=np.random.default_rng(3))
    torch.cuda.synchronize()
    counts = ext.launch_counts()
    for kern in ("ntt_fwd", "key_mul", "fused_rerank_intt", "score_topk"):
        assert counts.get(kern, 0) > 0, (kern, counts)
    for kern in ("ntt_inv", "pointwise_mul", "fused_rerank"):
        assert counts.get(kern, 0) == 0, (kern, counts)
    assert got["index"].dim == 256
    assert got["recall"] == want["recall"] == 1.0
    assert got["ids"].tolist() == want["ids"].tolist()
    assert got["transcript"].total_bytes == want["transcript"].total_bytes
    truth = (got["index"].rows(got["candidate_ids"]).double()
             @ torch.from_numpy(got["taste"]).to(cuda).double())
    assert np.abs(got["scores"] - truth.cpu().numpy()).max() <= 2e-3


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_train_step_card_equals_cpu(cuda, arch):
    """Two `make_lm_run` steps (2 microbatches) of the reduced config from
    the same weights, on the CPU and on the card, float32 with TF32 off:
    losses within 1e-5 relative, parameters within 1e-4 normwise, no
    kernel of ours launched.  Each step's batch must be clear of router
    near-ties (gap > 1e-4) under the CPU's weights of that step."""
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer

    cfg = registry.get(arch).reduced
    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(1),
                      device="cpu")
    card = Transformer(cfg, generator=torch.Generator().manual_seed(1),
                       device=cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ext.reset_launches()
    try:
        losses = []
        for model in (cpu, card):
            step_fn, batches_fn, state = train.make_lm_run(
                cfg, batch=4, seq=32, lr=3e-3, steps=2, microbatches=2,
                model=model)
            hist = []
            for i in range(2):
                if model is cpu:
                    assert _router_gap(cpu, batches_fn(i)[0]) > 1e-4
                state, m = step_fn(state, batches_fn(i))
                hist.append(m)
            losses.append(hist)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ext.launch_counts() == {}
    for got, want in zip(losses[1], losses[0]):
        assert np.isfinite(got["loss"]) and np.isfinite(got["grad_norm"])
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    want = dict(cpu.named_parameters())
    for k, p in card.named_parameters():
        w = want[k].detach().double()
        err = torch.linalg.vector_norm(p.detach().cpu().double() - w)
        assert float(err) <= 1e-4 * float(torch.linalg.vector_norm(w)), k


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """A world of one ``nccl`` rank on the card, torn down after the test."""
    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_ranks("nccl", store_path=tmp_path / "store", rank=0,
                        world_size=1, timeout_s=120)
    try:
        yield mesh_lib
    finally:
        mesh_lib.shutdown()


@pytest.mark.parametrize("n_rows", [20_000, 10**6])
def test_world1_nccl_mesh_search_equals_flat_kernel_scan(cuda, nccl_world,
                                                         n_rows):
    """A mesh-built index on a world-1 ``nccl`` mesh runs the score-top-k
    kernel on its block and equals the flat scan bit for bit (also at the
    paper's 10^6 x 768)."""
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk

    rng = np.random.default_rng(21)
    e = rng.standard_normal(size=(n_rows, 768), dtype=np.float32)
    q = torch.from_numpy(rng.normal(size=(8, 768)).astype(np.float32))
    mesh = nccl_world.make_mesh((1,), ("data",), device=cuda,
                                backend="nccl")
    flat = FlatIndex.build(e, device=cuda)
    sharded = FlatIndex.build(e, mesh=mesh)
    want = distributed_topk(flat, q.to(cuda), 161)
    ext.reset_launches()
    got = distributed_topk(sharded, q.to(cuda), 161)
    assert ext.launch_counts().get("score_topk", 0) == 1
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.indices, want.indices)
    assert got.exact and sharded.num_rows == n_rows


def test_world1_nccl_moe_sharded_equals_einsum(cuda, nccl_world):
    """``moe_fwd_sharded`` on a world-1 (1, 1) ``nccl`` mesh (every expert
    on the one EP rank) equals ``moe_fwd_einsum`` bit for bit, output and
    aux (float32, TF32 off)."""
    from repro_torch.models import moe as moe_lib

    mesh = nccl_world.make_mesh((1, 1), ("data", "model"), device=cuda,
                                backend="nccl")
    kw = dict(d_model=256, d_ff=128, n_experts=16, top_k=4)
    spec_e = moe_lib.MoeSpec(**kw)
    spec_s = moe_lib.MoeSpec(**kw, batch_axes=("data",), ep_axis="model",
                             impl="shard_a2a", mesh=mesh)
    gen = torch.Generator(device=cuda).manual_seed(2)
    layer = moe_lib.Moe(spec_e, gen, cuda)
    x = torch.randn((4, 64, 256), generator=gen, device=cuda)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, want_aux = moe_lib.moe_fwd_einsum(layer, x, spec_e)
        got, got_aux = moe_lib.moe_fwd(layer, x, spec_s)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)


def _kineto(prof):
    """(user ranges, device operations, launch times, event records) of a
    profiler session: ranges as (start_ns, end_ns, name), operations as
    (start_ns, end_ns, correlation id), launches {correlation id:
    start_ns}, the host's ``cudaEventRecord`` calls as sorted (start_ns,
    end_ns)."""
    cuda_type = torch.autograd.DeviceType.CUDA
    ranges, ops, launch, records = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda_type:
            if not e.is_user_annotation():
                s = e.start_ns()
                ops.append((s, s + e.duration_ns(), e.correlation_id()))
        elif e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
            if e.name().startswith("cudaEventRecord"):
                records.append((e.start_ns(), e.end_ns()))
    return ranges, ops, launch, sorted(records)


def test_device_stage_spans_end_with_their_stages_on_card(cuda):
    """A traced engine batch of 4 on the card (10^5 x 256, RLWE N 4096),
    the second of a `torch.profiler` session: the ``<stage>_device`` spans
    come in stage order, tile the dispatch's device timeline, end at or
    before d's copy returns, and each ends within 50 us of the later of
    two points: the end of the last device operation launched inside its
    stage's ``repro_torch/<stage>`` range (decrypt: before
    ``decrypt_copy``), and the host's record of its mark (where the device
    idled before it, as at this size with the profiler on).  The
    profiler's clock is mapped onto the tracer's by the host spans' own
    ranges."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.engine import DEVICE_STEPS
    from repro_torch.serve.session import SessionManager

    rng = np.random.default_rng(26)
    e = rng.normal(size=(100_000, 256)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    eng = ServeEngine(
        FlatIndex.build(e, documents=[b"d"] * len(e), normalize=False,
                        device=cuda),
        config=EngineConfig(max_batch=4, max_wait_s=30.0, trace=True),
        sessions=SessionManager(deterministic_seeds=True, device=cuda))
    for t in ("a", "b"):
        eng.open_session(t, n=256, N=len(e), k=5, plan_kwargs={"kprime": 161})
    queries = e[rng.integers(len(e), size=8)]

    def batch(qs):
        for i, q in enumerate(qs):
            eng.submit("ab"[i % 2], q, key=i)
        assert all(r.ok for r in eng.drain())

    batch(queries[:4])                      # builds, warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler's first device timestamps of a session sit up to
        # ~0.3 ms off its host clock: the second batch is the one read
        batch(queries[:4])
        batch(queries[4:])
        torch.cuda.synchronize()
    eng.close()
    spans = eng.tracer.spans()
    bid = max(s.batch_id for s in spans if s.batch_id is not None)
    mine = [s for s in spans if s.batch_id == bid]
    dev = [s for s in mine if s.track == obs.DEVICE_TRACK]
    assert [s.name for s in dev] == [f"{s}_device" for s in DEVICE_STEPS]
    assert all(s.attrs == {"lanes": 4} for s in dev)
    for a, b in zip(dev, dev[1:]):
        assert a.t_end == pytest.approx(b.t_start, abs=1e-9)
        assert a.duration_s >= 0
    (copy,) = [s for s in mine if s.name == "decrypt_copy"]
    assert dev[-1].t_end <= copy.t_end

    ranges, ops, launch, records = _kineto(prof)
    d0, d1 = max(r[:2] for r in ranges if r[2] == "repro_torch/dispatch")
    ranges = [r for r in ranges if d0 <= r[0] <= d1]
    # the profiler's s less the tracer's: a host span reads the clock,
    # opens its range, closes it and reads the clock again, so the offset
    # is at most each range's start less its span's start and at least
    # each range's end less its span's end
    hi, lo = np.inf, -np.inf
    for name in ("dispatch", "perturb", "topk", "score", "decrypt",
                 "decrypt_copy", "decrypt_crt"):
        rs = sorted(r for r in ranges if r[2] == f"repro_torch/{name}")
        ss = sorted((s for s in mine if s.name == name),
                    key=lambda s: s.t_start)
        assert len(rs) == len(ss), name
        for r, s in zip(rs, ss):
            hi = min(hi, r[0] / 1e9 - s.t_start)
            lo = max(lo, r[1] / 1e9 - s.t_end)
    off = (lo + hi) / 2

    def inside(t, name):
        return any(r0 <= t < r1 for r0, r1, n in ranges
                   if n == f"repro_torch/{name}")

    # a mark runs on the device when its stage's last operation has ended
    # and the host has recorded it (the first cudaEventRecord after that
    # operation's launch), whichever is later
    gaps = []
    for span, stage in zip(dev, DEVICE_STEPS):
        last = max(((e1, launch[corr]) for _, e1, corr in ops
                    if corr in launch and inside(launch[corr], stage)
                    and not inside(launch[corr], "decrypt_copy")),
                   default=None)
        assert last is not None, stage
        rec = min((r1 for r0, r1 in records if r0 >= last[1]),
                  default=np.inf)
        end = (span.t_end + off) * 1e9
        gaps.append((stage, (end - last[0]) / 1e3, (end - rec) / 1e3))
    print(f"offset within {hi - lo:.3g} s; device end less (the last "
          f"operation's end, the mark's record call's end), us: {gaps}")
    assert -2e-6 <= hi - lo <= 20e-6, (lo, hi)
    for stage, after_op, after_rec in gaps:
        assert after_op >= -20, (stage, after_op)
        assert abs(min(after_op, after_rec)) <= 50, stage
