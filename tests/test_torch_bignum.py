"""The port's RNS Montgomery bignum ops (`repro_torch.kernels.bignum`) on
the CPU: its numpy reference copy against the JAX package's
``repro.kernels.bignum.ref`` (pure numpy, so it runs here as it is), and
the float64 tensor ops against that reference and Python's ``pow``, bit for
bit, at 24 and 46 channels (n^2 of 256- and 512-bit Paillier keys) and at
the 64-channel edge of the vectorization budget."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.crypto import paillier as jpai
from repro.kernels.bignum import ref as jref
from repro_torch.crypto import paillier as pai
from repro_torch.kernels.bignum import ops, ref

CPU = torch.device("cpu")


def _modulus(channels):
    """n^2 of a Paillier key whose n^2 needs ``channels`` channels."""
    bits = {24: 256, 46: 512, 64: 726}[channels]
    m = pai.keygen(bits, rng=np.random.default_rng(bits)).pub.n_sq
    assert ref.num_channels(m) == channels
    return m


@pytest.fixture(scope="module", params=[24, 46, 64], ids=lambda s: f"s{s}")
def ctx(request):
    return ref.for_modulus(_modulus(request.param))


def _rand_ints(rng, modulus, count):
    return [int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62))
            * int(rng.integers(0, 2**62)) % modulus for _ in range(count)]


def _mont(ctx, xs):
    return ref.to_rns(ctx, [ref.to_mont(ctx, x) for x in xs])


def _consts(ctx, batch_ndim=2):
    return ops.make_consts(ctx.system, [ctx], batch_ndim, device=CPU)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("bits", [256, 512])
def test_ref_copy_matches_reference(bits):
    """The port's numpy reference is the JAX package's, constant for
    constant and conversion for conversion."""
    m = pai.keygen(bits, rng=np.random.default_rng(bits)).pub.n_sq
    assert m == jpai.keygen(bits, rng=np.random.default_rng(bits)).pub.n_sq
    got, want = ref.for_modulus(m), jref.for_modulus(m)
    for name in ("E1", "E2", "Minv_t", "c4", "Mp_mod_m", "mv", "mpv", "tgt",
                 "allm", "pow2"):
        np.testing.assert_array_equal(getattr(got.system, name),
                                      getattr(want.system, name))
    assert got.system.m == want.system.m and got.system.mp == want.system.mp
    for name in ("c1", "NMinv_t", "one", "plain_one"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    vals = _rand_ints(np.random.default_rng(1), m, 9) + [0, 1, m - 1]
    np.testing.assert_array_equal(ref.to_rns(got, vals),
                                  jref.to_rns(want, vals))
    a, b = _mont(got, vals[:5]), _mont(got, vals[5:10])
    np.testing.assert_array_equal(ref.mont_mul(got, a, b),
                                  jref.mont_mul(want, a, b))
    assert ref.from_rns(got, a) == jref.from_rns(want, a)
    assert ref.modmul(got, vals[0], vals[1]) == vals[0] * vals[1] % m


def test_budget_boundaries():
    assert (ref.MAX_CHANNELS, ref.HARD_CHANNELS) == (64, 128)
    for kb, should_fit in ((256, True), (512, True), (1024, False)):
        m = (1 << 2 * kb) - 1
        assert ref.fits(m) == jref.fits(m) == should_fit
        assert ref.num_channels(m) == jref.num_channels(m)
    assert ref.num_channels((1 << 2048) - 1) == 90


def test_ops_mont_mul_matches_ref_and_pow(ctx):
    rng = np.random.default_rng(6)
    a = _rand_ints(rng, ctx.modulus, 5)
    b = _rand_ints(rng, ctx.modulus, 5)
    am, bm = _mont(ctx, a), _mont(ctx, b)
    got = ops.mont_mul(_t(am[None]), _t(bm[None]), _consts(ctx)).numpy()[0]
    np.testing.assert_array_equal(got, ref.mont_mul(ctx, am, bm))
    for x, y, g in zip(a, b, ref.from_rns(ctx, got)):
        assert ref.from_mont(ctx, g) % ctx.modulus == x * y % ctx.modulus


def test_ops_mont_mul_chain(ctx):
    """40 squarings: the incomplete-reduction domain must not drift, and
    every step equals the reference's channels."""
    x = _rand_ints(np.random.default_rng(3), ctx.modulus, 1)[0]
    vec = _mont(ctx, [x])
    got, C = _t(vec[None]), _consts(ctx)
    want = x
    for _ in range(40):
        vec = ref.mont_mul(ctx, vec, vec)
        got = ops.mont_mul(got, got, C)
        want = want * want % ctx.modulus
    np.testing.assert_array_equal(got.numpy()[0], vec)
    assert ref.from_mont(ctx, ref.from_rns(ctx, vec)[0]) % ctx.modulus == want
    np.testing.assert_array_equal(ops.square_n(_t(_mont(ctx, [x])[None]), C,
                                               40).numpy()[0], vec)


def test_ops_windowed_exp_matches_pow(ctx):
    rng = np.random.default_rng(7)
    bases = _rand_ints(rng, ctx.modulus, 3)
    exps = [0, int(rng.integers(1, 2**60)), ctx.modulus >> 7]
    window = 4
    base = _t(_mont(ctx, bases)[None])
    digits = torch.from_numpy(ops.to_digits(exps, window)[None])
    C = _consts(ctx)
    acc = ops.mont_exp_digits(ops.pow_table(base, C, window), digits, C,
                              window)
    for x, e, g in zip(bases, exps, ref.from_rns(ctx, acc.numpy()[0])):
        assert ref.from_mont(ctx, g) % ctx.modulus == pow(x, e, ctx.modulus)
    # the reference's square-and-multiply gives the same residue mod N
    want = ref.mont_exp(ctx, _mont(ctx, bases[1:2]), exps[1])
    assert (ref.from_rns(ctx, want)[0] % ctx.modulus
            == ref.from_rns(ctx, acc.numpy()[0, 1:2])[0] % ctx.modulus)


@pytest.mark.parametrize("count", [1, 2, 5, 8])
def test_ops_product_reduce_matches_python(ctx, count):
    xs = _rand_ints(np.random.default_rng(8 + count), ctx.modulus, count)
    vec = _mont(ctx, xs)
    got = ops.product_reduce(_t(vec[None]), _consts(ctx)).numpy()[0]
    want = 1
    for x in xs:
        want = want * x % ctx.modulus
    # the odd-aware tree performs count-1 mont_muls: one residual M factor
    g = ref.from_rns(ctx, got[None])[0]
    assert ref.from_mont(ctx, g) % ctx.modulus == want


def test_lanes_of_different_keys_share_one_call():
    """Two keys of one channel count in one batch: per-lane constants
    broadcast, and each lane equals its own single-key call."""
    ctxs = [ref.for_modulus(pai.keygen(
        256, rng=np.random.default_rng(40 + i)).pub.n_sq) for i in range(2)]
    assert ctxs[0].system is ctxs[1].system
    rng = np.random.default_rng(9)
    a = [_mont(c, _rand_ints(rng, c.modulus, 4)) for c in ctxs]
    b = [_mont(c, _rand_ints(rng, c.modulus, 4)) for c in ctxs]
    C = ops.make_consts(ctxs[0].system, ctxs, 2, device=CPU)
    got = ops.mont_mul(_t(np.stack(a)), _t(np.stack(b)), C).numpy()
    for j, c in enumerate(ctxs):
        np.testing.assert_array_equal(got[j], ref.mont_mul(c, a[j], b[j]))
    with pytest.raises(ValueError, match="share one channel count"):
        ops.make_consts(ctxs[0].system, [ctxs[0], ref.for_modulus(
            _modulus(46))], 2, device=CPU)
    # a second system object of the same channel count (two threads racing
    # on `get_system`'s first call) is the same system
    twin = dataclasses.replace(ctxs[1],
                               system=ref.get_system.__wrapped__(24))
    assert twin.system is not ctxs[0].system
    C = ops.make_consts(ctxs[0].system, [ctxs[0], twin], 2, device=CPU)
    np.testing.assert_array_equal(
        ops.mont_mul(_t(np.stack(a)), _t(np.stack(b)), C).numpy(), got)


def test_gather_table_is_take_along_axis():
    rng = np.random.default_rng(10)
    table = rng.integers(0, 1000, size=(6, 2, 3, 4, 5)).astype(np.float64)
    idx = rng.integers(0, 6, size=(2, 3, 4))
    want = np.take_along_axis(table, idx[None, ..., None], axis=0)[0]
    np.testing.assert_array_equal(
        ops.gather_table(_t(table), torch.from_numpy(idx)).numpy(), want)


def test_mont_mul_counts():
    c = ref.for_modulus(_modulus(24))
    x = _t(_mont(c, [3, 5, 7])[None])
    ops.reset_mont_mul_counts()
    ops.square_n(x, _consts(c), 4)
    assert ops.mont_mul_counts() == {"calls": 4, "values": 12}


def test_to_digits_round_trip():
    window = 5
    exps = [0, 1, 31, 32, 12345, 2**64 - 1]
    digits = ops.to_digits(exps, window)
    for e, row in zip(exps, digits):
        back = 0
        for d in row:
            back = (back << window) | int(d)
        assert back == e
    with pytest.raises(ValueError, match="wider"):
        ops.to_digits([2**20], window, positions=2)
