"""Port NTT modules (repro_torch.kernels.ntt) against the JAX package.

The same numpy inputs go through the JAX Pallas kernels (interpret mode,
as the JAX package's own tests run them on the CPU) and through the port's
CPU path; integer outputs must match bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import modring as jmod
from repro.kernels.ntt import fused as jfused
from repro.kernels.ntt import ntt as jntt
from repro.kernels.ntt import ops as jops
from repro_torch.crypto import modring
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels.ntt import fused as tfused
from repro_torch.kernels.ntt import ntt as tntt
from repro_torch.kernels.ntt import ops
from repro_torch.kernels.ntt import ref

CASES = [(n, q) for n in (256, 1024) for q in modring.find_ntt_primes(2 * n, 3)]


def _polys(seed, shape, q):
    return ref.random_poly(np.random.default_rng(seed), shape, q)


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_prime_tables_match_reference(n):
    assert modring.find_ntt_primes(2 * n, 3) == jmod.find_ntt_primes(2 * n, 3)
    for q in modring.find_ntt_primes(2 * n, 3):
        t, j = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
        np.testing.assert_array_equal(t.psi_table, j.psi_table)
        np.testing.assert_array_equal(t.ipsi_table, j.ipsi_table)
        assert (t.n_inv, t.mu) == (j.n_inv, j.mu)
        assert t.barrett64 == (1 << 64) // q


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_shoup_tables_match_python_ints(n):
    """The NTT kernel's Shoup quotients floor(w * 2^32 / q), one per
    twiddle (uint32 in int32 bits), and the inverse's last stage with N^-1
    folded in: (N^-1, psi^-1 * N^-1) and their quotients."""
    for q in modring.find_ntt_primes(2 * n, 3):
        ctx = PrimeCtx.build(q, n)
        for kind in ("psi", "ipsi"):
            w = ctx.table(kind, torch.device("cpu")).numpy()
            got = ctx.table(kind + "_shoup", torch.device("cpu"))
            assert got.dtype == torch.int32 and got.shape == (n,)
            want = [(int(x) << 32) // q for x in w]
            assert got.numpy().view(np.uint32).tolist() == want
        n_inv, n_inv_s, w, ws = ctx.inv_tail
        assert n_inv * n % q == 1 and n_inv_s == (n_inv << 32) // q
        ipsi = pow(int(ctx.psi_table[1]), -1, q)
        assert int(ctx.ipsi_table[1]) == ipsi
        assert w == ipsi * n_inv % q and ws == (w << 32) // q
        # a Shoup product a * w - umulhi(a, ws) * q in 32-bit arithmetic is
        # a * w mod q or that plus q, for any 32-bit a (the kernel's lazy
        # values stay below 4q)
        a = np.random.default_rng(n).integers(0, 4 * q, 1000).astype(np.uint64)
        for c, cs in ((n_inv, n_inv_s), (w, ws)):
            r = (a * c - ((a * cs) >> 32) * q) % (1 << 32)
            assert bool(np.all(r < 2 * q)) and bool(np.all(r % q == a * c % q))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n,q", CASES)
def test_ntt_matches_pallas_bit_for_bit(n, q, batch):
    ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
    x = _polys(n + batch, (batch, n), q)
    fwd = ops.ntt_fwd(torch.from_numpy(x), ctx)
    inv = ops.ntt_inv(torch.from_numpy(x), ctx)
    want_f = jntt.ntt_pallas(jnp.asarray(x), jctx, interpret=True)
    want_i = jntt.ntt_pallas(jnp.asarray(x), jctx, inverse=True, interpret=True)
    assert fwd.dtype == torch.int32
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(ops.ntt_inv(fwd, ctx).numpy(), x)


@pytest.mark.parametrize("n,q", CASES)
def test_pointwise_matches_pallas(n, q):
    ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
    a, b = _polys(1, (8, n), q), _polys(2, (8, n), q)
    got = ops.pointwise_mul(torch.from_numpy(a), torch.from_numpy(b), ctx)
    want = jntt.pointwise_mul_pallas(jnp.asarray(a), jnp.asarray(b), jctx,
                                     interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), modring.mod_mul_np(a, b, q))


@pytest.mark.parametrize("n,q", CASES)
def test_negacyclic_mul_matches_schoolbook(n, q):
    ctx = PrimeCtx.build(q, n)
    a, b = _polys(3, (1, n), q), _polys(4, (1, n), q)
    got = ops.negacyclic_mul(torch.from_numpy(a), torch.from_numpy(b), ctx)
    np.testing.assert_array_equal(got.numpy(),
                                  jmod.negacyclic_mul_np(a, b, q))


def test_ntt_leading_dims_match_xla_reference():
    n = 1024
    q = modring.find_ntt_primes(2 * n, 1)[0]
    ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
    x = _polys(5, (2, 3, n), q)
    got = ops.ntt_fwd(torch.from_numpy(x), ctx)
    want = jops.ntt_fwd(jnp.asarray(x), jctx, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (B, num_ct, cpt, chunks): n_dim <= chunk (stride = chunk, cpt = 2) and
# n_dim > chunk (stride = 2*chunk, cpt = 1, 2 chunks) at the 1024 ring
@pytest.mark.parametrize("bsz,num_ct,cpt,chunks", [(2, 3, 2, 1), (1, 2, 1, 2)])
@pytest.mark.parametrize("pi", [0, 1, 2])
def test_fused_rerank_intt_matches_pallas(bsz, num_ct, cpt, chunks, pi):
    n = 1024
    q = modring.find_ntt_primes(2 * n, 3)[pi]
    ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
    polys = _polys(6, (bsz, num_ct, cpt * chunks, n), q)
    tw, f0, f1 = (_polys(7, (cpt, n), q), _polys(8, (bsz, chunks, n), q),
                  _polys(9, (bsz, chunks, n), q))
    got = ops.fused_rotate_hadamard_intt(*map(torch.from_numpy,
                                              (polys, tw, f0, f1)), ctx)
    want = jfused.fused_rerank_intt_pallas(*map(jnp.asarray,
                                                (polys, tw, f0, f1)), jctx,
                                           interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # staged: rotate/Hadamard/mod-sum in the NTT domain, then the inverse
    acc = ref.fused_rotate_hadamard_ref(*map(torch.from_numpy,
                                             (polys, tw, f0, f1)), ctx)
    for g, a in zip(got, acc):
        assert torch.equal(g, ops.ntt_inv(a, ctx))


@pytest.mark.parametrize("bsz,num_ct,cpt,chunks", [(2, 3, 2, 1), (1, 2, 1, 2)])
@pytest.mark.parametrize("pi", [0, 2])
def test_fused_rerank_matches_reference(bsz, num_ct, cpt, chunks, pi):
    """The staged re-rank (NTT-domain accumulators out) against the
    reference's `fused_rotate_hadamard` on its Pallas kernel (interpret
    mode) and on its XLA path; staged + inverse NTT equals the fused-iNTT
    path (the staged witness of the sharded-cache suite)."""
    n = 1024
    q = modring.find_ntt_primes(2 * n, 3)[pi]
    ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
    polys = _polys(16, (bsz, num_ct, cpt * chunks, n), q)
    tw, f0, f1 = (_polys(17, (cpt, n), q), _polys(18, (bsz, chunks, n), q),
                  _polys(19, (bsz, chunks, n), q))
    args = list(map(torch.from_numpy, (polys, tw, f0, f1)))
    got = ops.fused_rotate_hadamard(*args, ctx)
    for use_pallas in (True, False):
        want = jops.fused_rotate_hadamard(*map(jnp.asarray, (polys, tw, f0, f1)),
                                          jctx, use_pallas=use_pallas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, f in zip(got, ops.fused_rotate_hadamard_intt(*args, ctx)):
        assert torch.equal(ops.ntt_inv(g, ctx), f)


# gathered cache rows (B, nc, chunks, P, N) as the caches' gathers return
# them, as (cpt, chunks, nc): the last result ciphertext full (pad 0) or
# with 1 or 3 empty slots, one and two chunks
GATHERED = [(2, 1, 6), (2, 1, 5), (1, 2, 3), (4, 2, 5)]


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("cpt,chunks,nc", GATHERED)
def test_fused_gathered_matches_padded_path_and_pallas(n, cpt, chunks, nc):
    """The gathered entry's plain branch (the CPU path of the serving
    pipeline) equals, on every prime, the zero pad + per-prime reshape +
    `fused_rotate_hadamard_intt` path it replaces, and the reference's
    `fused_rerank_intt_pallas` (interpret mode) on the padded rows."""
    qs = modring.find_ntt_primes(2 * n, 3)
    bsz = 2
    g = np.stack([_polys(20 + i, (bsz, nc, chunks, n), q)
                  for i, q in enumerate(qs)], axis=3)
    pad = -(-nc // cpt) * cpt - nc
    padded = np.concatenate(
        [g, np.zeros((bsz, pad) + g.shape[2:], np.int32)], axis=1)
    num_ct = padded.shape[1] // cpt
    assert num_ct == -(-nc // cpt)
    for i, q in enumerate(qs):
        ctx, jctx = PrimeCtx.build(q, n), jmod.PrimeCtx.build(q, n)
        tw, f0, f1 = (_polys(30 + i, (cpt, n), q),
                      _polys(40 + i, (bsz, chunks, n), q),
                      _polys(50 + i, (bsz, chunks, n), q))
        tw_t = torch.from_numpy(tw)
        got = ops.fused_rotate_hadamard_intt_gathered(
            torch.from_numpy(g), i, nc, tw_t,
            modring.shoup_quotients(tw_t, q),
            *map(torch.from_numpy, (f0, f1)), ctx)
        polys = np.ascontiguousarray(padded[..., i, :]).reshape(
            bsz, num_ct, cpt * chunks, n)
        old = ops.fused_rotate_hadamard_intt(
            *map(torch.from_numpy, (polys, tw, f0, f1)), ctx)
        want = jfused.fused_rerank_intt_pallas(
            *map(jnp.asarray, (polys, tw, f0, f1)), jctx, interpret=True)
        for gz, oz, wz in zip(got, old, want):
            assert gz.shape == (bsz, num_ct, n)
            assert torch.equal(gz, oz)
            np.testing.assert_array_equal(gz.numpy(), np.asarray(wz))


def test_gathered_polys_drops_and_pads():
    """`gathered_polys`: candidates past num_cands dropped, the last
    ciphertext's empty slots zero, slot-major (cand, chunk) rows."""
    g = torch.arange(2 * 6 * 2 * 3 * 4, dtype=torch.int32).reshape(
        2, 6, 2, 3, 4)
    rows = ref.gathered_polys(g, 1, 5, 2)
    assert rows.shape == (2, 3, 4, 4)
    assert torch.equal(rows[:, :2].reshape(2, 4, 2, 4), g[:, :4, :, 1])
    assert torch.equal(rows[:, 2, :2], g[:, 4, :, 1])
    assert not bool(rows[:, 2, 2:].any())


def test_fused_accumulator_overflow_is_refused():
    n = 1024
    q = modring.find_ntt_primes(2 * n, 1)[0]
    x = torch.zeros((1, 1, 4096, n), dtype=torch.int32)
    with pytest.raises(AssertionError):
        ref.fused_rotate_hadamard_ref(x, torch.zeros((4096, n), dtype=torch.int32),
                                      torch.zeros((1, 1, n), dtype=torch.int32),
                                      torch.zeros((1, 1, n), dtype=torch.int32),
                                      PrimeCtx.build(q, n))


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor only the ops layer's plain path runs; the kernel
    wrappers never silently compute on the CPU."""
    n = 256
    ctx = PrimeCtx.build(modring.find_ntt_primes(2 * n, 1)[0], n)
    x = torch.zeros((1, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        tntt.ntt_cuda(x, ctx)
    with pytest.raises(ValueError):
        tntt.pointwise_mul_cuda(x, x, ctx)
    with pytest.raises(ValueError):
        tfused.fused_rerank_intt_cuda(x[None, None], x, x, x[None], x[None],
                                      ctx)
    with pytest.raises(ValueError):
        tfused.fused_rerank_cuda(x[None, None], x, x, x[None], x[None], ctx)
    g = torch.zeros((1, 1, 1, 1, n), dtype=torch.int32)
    with pytest.raises(ValueError):
        tfused.fused_rerank_intt_gathered_cuda(g, 0, 1, x, x, x[None],
                                               x[None], ctx)
