"""The RLWE key product (repro_torch.kernels.ntt.ops.key_mul) and the
broadcast pointwise product against the JAX package.

``key_mul`` computes, for every prime p, iNTT_p(NTT_p(a[..., p, :]) *
s[..., p, :]): the chain the reference's ``encrypt_query`` and
``decrypt_rns`` run prime by prime.  The same numpy inputs go through the
reference's Pallas kernels (interpret mode, as the JAX package's own tests
run them on the CPU) and through the port's CPU path; integer outputs must
match bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.crypto import modring as jmod
from repro.kernels.ntt import ntt as jntt
from repro_torch.crypto import modring, rlwe
from repro_torch.crypto.modring import PrimeCtx
from repro_torch.kernels.ntt import ops
from repro_torch.kernels.ntt import ref

BSZ, NUM_CT = 2, 3


def _ctxs(n):
    qs = modring.find_ntt_primes(2 * n, 3)
    return ([PrimeCtx.build(q, n) for q in qs],
            [jmod.PrimeCtx.build(q, n) for q in qs])


def _draw(rng, shape, ctxs):
    """(..., P, N) residues, prime p's slice in [0, q_p)."""
    return np.stack([ref.random_poly(rng, shape, c.q) for c in ctxs],
                    axis=-2)


def _jax_chain(a, s, jctxs):
    """The reference's per-prime chain on (..., P, N) numpy arrays, each
    prime's rows flattened to (rows, N) as its kernels take them."""
    out = np.empty(a.shape, np.int32)
    s = np.broadcast_to(s, a.shape)
    for i, c in enumerate(jctxs):
        x = jnp.asarray(a[..., i, :].reshape(-1, c.n))
        k = jnp.asarray(np.ascontiguousarray(s[..., i, :]).reshape(-1, c.n))
        f = jntt.ntt_pallas(x, c, interpret=True)
        y = jntt.ntt_pallas(jntt.pointwise_mul_pallas(f, k, c, interpret=True),
                            c, inverse=True, interpret=True)
        out[..., i, :] = np.asarray(y).reshape(a.shape[:-2] + (c.n,))
    return out


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
@pytest.mark.parametrize("keys", ["one", "tenant"])
@pytest.mark.parametrize("n", [16, 256, 4096])
def test_key_mul_matches_reference_chain(n, keys, layout):
    """Every prime of the ring, one key (P, N) or per-tenant keys
    (B, 1, P, N), a contiguous or a strided (B, num_ct, P, N) view (prime
    -major as encryption draws it, and a slice of a wider array)."""
    ctxs, jctxs = _ctxs(n)
    rng = np.random.default_rng(n)
    a = _draw(rng, (BSZ, NUM_CT, n), ctxs)
    s = _draw(rng, (n,) if keys == "one" else (BSZ, 1, n), ctxs)
    want = _jax_chain(a, s, jctxs)
    if layout == "contiguous":
        at = torch.from_numpy(a)
    else:
        wide = np.zeros((len(ctxs) + 2, BSZ, NUM_CT, n), np.int32)
        wide[1:-1] = np.moveaxis(a, -2, 0)
        at = torch.from_numpy(wide)[1:-1].permute(1, 2, 0, 3)
        assert not at.is_contiguous()
    got = ops.key_mul(at, torch.from_numpy(s), ctxs)
    assert got.dtype == torch.int32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("prime", [0, 1, 2])
def test_pointwise_expanded_b_matches_pallas(prime):
    """b expanded over a's leading dims (the baseline's fresh packing:
    f0[:, None].expand(pk.shape)) equals the reference's product with b
    written out."""
    n = 256
    ctx, jctx = PrimeCtx.build(modring.find_ntt_primes(2 * n, 3)[prime], n), \
        jmod.PrimeCtx.build(jmod.find_ntt_primes(2 * n, 3)[prime], n)
    rng = np.random.default_rng(prime)
    a = ref.random_poly(rng, (BSZ, NUM_CT, 2, n), ctx.q)
    f = ref.random_poly(rng, (BSZ, 2, n), ctx.q)
    b = torch.from_numpy(f)[:, None].expand(a.shape)
    assert b.stride(1) == 0
    got = ops.pointwise_mul(torch.from_numpy(a), b, ctx)
    full = np.ascontiguousarray(np.broadcast_to(f[:, None], a.shape))
    want = jntt.pointwise_mul_pallas(jnp.asarray(a.reshape(-1, n)),
                                     jnp.asarray(full.reshape(-1, n)), jctx,
                                     interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(a.shape))


@pytest.mark.parametrize("key_shape", [(3, 1), (1, NUM_CT), (BSZ, NUM_CT, 1),
                                       (BSZ, 2)])
def test_key_mul_refuses_keys_that_do_not_broadcast(key_shape):
    """Keys are one or one per leading prefix of a (then 1s): anything else
    raises on every device, before any work."""
    n = 16
    ctxs, _ = _ctxs(n)
    a = torch.zeros((BSZ, NUM_CT, len(ctxs), n), dtype=torch.int32)
    s = torch.zeros(key_shape + (len(ctxs), n), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not broadcast"):
        ops.key_mul(a, s, ctxs)


def test_rlwe_round_makes_one_key_product_per_call(monkeypatch):
    """Encryption and decryption (one request's and a batch's) each make
    one key product over every prime and no standalone pointwise product
    or inverse NTT."""
    params = rlwe.RlweParams(n_poly=1024, chunk=512)
    rng = np.random.default_rng(0)
    calls = []

    def count(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    for name in ("key_mul", "pointwise_mul", "ntt_inv"):
        monkeypatch.setattr(rlwe.ntt_ops, name,
                            count(name, getattr(ops, name)))
    sks = [rlwe.keygen(params, rng, device="cpu") for _ in range(2)]
    e = rng.normal(size=(2, 700))
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    calls.clear()
    cts = [rlwe.encrypt_query(sk, v, rng) for sk, v in zip(sks, e)]
    assert calls == ["key_mul", "key_mul"]
    assert cts[0].c0.shape == cts[0].c1.shape == (2, 3, 1024)
    res = rlwe.ScoreCiphertexts(c0=cts[0].c0, c1=cts[0].c1, n_dim=700,
                                num_cands=1)
    calls.clear()
    rlwe.decrypt_scores(sks[0], res)
    rlwe.decrypt_scores_batch(sks, [res, rlwe.ScoreCiphertexts(
        c0=cts[1].c0, c1=cts[1].c1, n_dim=700, num_cands=1)])
    assert calls == ["key_mul", "key_mul"]
