"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device every test here skips.
Run them on a GPU host with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and numpy only (no JAX), so it runs where the JAX
package is not installed.
"""

import numpy as np
import pytest
import torch

import threading

from repro_torch.crypto import modring
from repro_torch.crypto import rlwe
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels import ext
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.kernels.ntt import ref as nref
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.kernels.scoretopk import ref as sref
from repro_torch.kernels.scoretopk import scoretopk as kscore

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


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


@pytest.mark.parametrize("n,batch", [(256, 1), (1024, 8), (4096, 5)] + [
    (n, batch) for n in (256, 1024, 4096, 16384) for batch in (1, 41, 328)])
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
    (5, 777, 130, 16, 256, None)])         # dim % 4 != 0: 4-byte loads
def test_score_topk_kernel(cuda, b, n_rows, n, k, tile, special):
    rng = np.random.default_rng(n_rows)
    q = rng.normal(size=(b, n)).astype(np.float32)
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
    pv, pi = sref.tile_topk_ref(q, e, kk, t)
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
    plain = sops.topk_scores(q, e, k, tile=tile)
    torch.testing.assert_close(got.values.cpu(), plain.values, rtol=1e-5,
                               atol=1e-6)
    _assert_ids_equal_up_to_ties(got.indices.cpu(), plain.indices, q, e)
    if k > 1:
        assert float(got.values[0, 1]) == float(got.values[0, 0])  # the tie
    _assert_exact_ties_by_id(got.values.cpu(), got.indices.cpu())


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
    assert ext.launch_counts() == {"ntt_fwd": 1}
