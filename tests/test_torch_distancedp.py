"""Port DistanceDP and geometry against the JAX package.

`jax.random` cannot be replayed in torch, so the mechanism is held to the
reference by its distribution: Gamma(n, 1/eps) radii and uniform
directions, compared by moments and by a two-sample Kolmogorov-Smirnov
test against the reference's own draws.  The host geometry (numpy + scipy)
must agree exactly."""

import numpy as np
import pytest
import scipy.stats
import torch

import jax

from repro.core import distancedp as jdp
from repro.core import geometry as jgeo
from repro_torch.core import distancedp as dp
from repro_torch.core import geometry as geo


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_radial_moments_match_gamma():
    n, eps = 768, 10 * 768.0
    r = dp.sample_radial(_gen(1), n, eps, (20_000,))
    assert r.dtype == torch.float32 and tuple(r.shape) == (20_000,)
    assert float(r.mean()) == pytest.approx(n / eps, rel=0.02)
    assert float(r.var()) == pytest.approx(n / eps**2, rel=0.1)


@pytest.mark.parametrize("a", [0.5, 1.0, 3.0, 768.0])
def test_gamma_sampler_matches_distribution(a):
    """Marsaglia-Tsang (and the a < 1 boost) against scipy's Gamma CDF."""
    x = dp.sample_gamma(_gen(2), a, (8000,)).double().numpy()
    assert scipy.stats.kstest(x, scipy.stats.gamma(a).cdf).pvalue > 1e-3


def test_radius_distribution_matches_reference():
    n, eps = 384, 384 * 20.0
    ours = dp.sample_radial(_gen(3), n, eps, (5000,)).numpy()
    ref = np.asarray(jdp.sample_radial(jax.random.PRNGKey(3), n, eps, (5000,)))
    assert scipy.stats.ks_2samp(ours, ref).pvalue > 1e-3


def test_direction_uniform():
    v = dp.sample_direction(_gen(4), 64, (5000,))
    np.testing.assert_allclose(torch.linalg.norm(v, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    assert float(v.mean(0).abs().max()) < 0.05
    # a coordinate of a uniform unit vector matches the reference's
    ref = np.asarray(jdp.sample_direction(jax.random.PRNGKey(4), 64, (5000,)))
    assert scipy.stats.ks_2samp(v[:, 0].numpy(), ref[:, 0]).pvalue > 1e-3


def test_perturb_shapes_and_radius_consistency():
    e = dp.sample_direction(_gen(9), 384, (7,))
    out = dp.perturb(_gen(3), e, eps=384 * 20.0)
    assert tuple(out.embedding.shape) == (7, 384)
    d = torch.linalg.norm(out.embedding - e, dim=-1)
    np.testing.assert_allclose(d.numpy(), out.radius.numpy(), rtol=1e-4)


def test_perturb_replays_from_the_generator_seed():
    e = np.ones(32, np.float32) / np.sqrt(32)
    a = dp.perturb(_gen(5), e, 100.0).embedding
    b = dp.perturb(_gen(5), e, 100.0).embedding
    c = dp.perturb(_gen(6), e, 100.0).embedding
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_distancedp_inequality():
    """Definition 1: |log p(y|x) - log p(y|x')| <= eps * ||x - x'||."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(2, 65))
        eps = float(rng.uniform(0.1, 1e4))
        x, x_alt = rng.normal(size=(n,)), rng.normal(size=(n,))
        ys = rng.normal(size=(16, n)) * rng.uniform(0.1, 10)
        lr = dp.dp_log_ratio(ys, x, x_alt, eps).numpy()
        bound = eps * np.linalg.norm(x - x_alt) + 1e-2 * eps
        assert np.all(np.abs(lr) <= bound + 1e-4)
        np.testing.assert_allclose(
            lr, np.asarray(jdp.dp_log_ratio(ys, x, x_alt, eps)),
            rtol=1e-4, atol=1e-3 * eps)


def test_radius_helpers_match_reference():
    for n, eps in ((768, 7680.0), (384, 1e4), (64, 40.0)):
        for q in (0.5, 0.999):
            assert dp.radial_quantile_np(n, eps, q) == \
                jdp.radial_quantile_np(n, eps, q)
        assert dp.expected_radius(n, eps) == jdp.expected_radius(n, eps)
        assert dp.eps_for_radius(n, 0.03) == jdp.eps_for_radius(n, 0.03)


@pytest.mark.parametrize("n", [64, 384, 768])
def test_geometry_matches_reference(n):
    alphas = np.linspace(0.0, np.pi, 13)
    np.testing.assert_array_equal(geo.cap_fraction_np(alphas, n),
                                  jgeo.cap_fraction_np(alphas, n))
    np.testing.assert_allclose(geo.cap_fraction(alphas, n),
                               np.asarray(jgeo.cap_fraction(alphas, n)),
                               atol=1e-5)
    fracs = np.array([1e-6, 1e-3, 0.3, 0.5, 0.9])
    np.testing.assert_array_equal(geo.alpha_from_fraction_np(fracs, n),
                                  jgeo.alpha_from_fraction_np(fracs, n))
    for k, N, r in ((5, 10**6, 0.05), (3, 500, 1.6), (10, 2000, 0.03)):
        assert geo.kprime_for(k, N, n, r) == jgeo.kprime_for(k, N, n, r)
        assert geo.delta_k(k, N, n, r) == jgeo.delta_k(k, N, n, r)
        assert geo.leakage_requires_ot(k, N, n, n / r) == \
            jgeo.leakage_requires_ot(k, N, n, n / r)
    assert geo.mean_angle_omega(1.2, 5) == jgeo.mean_angle_omega(1.2, 5)
    np.testing.assert_array_equal(geo.perturbed_angle([0.1, 2.0], conservative=True),
                                  jgeo.perturbed_angle([0.1, 2.0], conservative=True))
