"""(n, eps)-DistanceDP mechanism (paper Definition 1 + Section 3.2.1), PyTorch.

Counterpart of ``repro/core/distancedp.py``.  Output ``e' = e + r * v`` with
``r ~ Gamma(n, 1/eps)`` and ``v`` uniform on the unit sphere.  Randomness
comes from an explicit `torch.Generator` on the embedding's device.
``torch.distributions.Gamma`` takes no generator, so the Gamma draw is
Marsaglia-Tsang on the generator's own normals and uniforms.  The draws
cannot replay ``jax.random``; the mechanism is held to the reference by
its distribution.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class Perturbation(NamedTuple):
    embedding: torch.Tensor  # e' = e + r*v, shape (..., n)
    radius: torch.Tensor     # r, shape (...,)
    direction: torch.Tensor  # v, unit-norm, shape (..., n)


def sample_gamma(generator: torch.Generator, a: float, shape=()) -> torch.Tensor:
    """Gamma(a, 1) float32 draws on the generator's device (Marsaglia-Tsang;
    a < 1 uses the Gamma(a + 1) * U^(1/a) boost)."""
    dev = generator.device
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    count = int(np.prod(shape, dtype=np.int64))
    out = torch.empty(count, dtype=torch.float64, device=dev)
    todo = torch.arange(count, device=dev)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=generator, dtype=torch.float64, device=dev)
        u = torch.rand(m, generator=generator, dtype=torch.float64, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok]
        todo = todo[~ok]
    if boost:
        u = torch.rand(count, generator=generator, dtype=torch.float64, device=dev)
        out = out * u ** (1.0 / a)
    return out.to(torch.float32).reshape(shape)


def sample_radial(generator: torch.Generator, n: int, eps, shape=()) -> torch.Tensor:
    """r ~ Gamma(shape=n, scale=1/eps).  Mean n/eps, concentrates for large n."""
    return sample_gamma(generator, float(n), shape) / float(eps)


def sample_direction(generator: torch.Generator, n: int, shape=()) -> torch.Tensor:
    """Uniform direction on S^{n-1} via normalized gaussians."""
    t = torch.randn(tuple(shape) + (n,), generator=generator,
                    dtype=torch.float32, device=generator.device)
    return t / torch.linalg.norm(t, dim=-1, keepdim=True)


def perturb(generator: torch.Generator, e, eps) -> Perturbation:
    """Apply the (n, eps)-DistanceDP mechanism to embedding(s) ``e``.

    ``e`` has shape (..., n) and lies on the generator's device; one
    independent perturbation per leading index.
    """
    e = torch.as_tensor(e, dtype=torch.float32, device=generator.device)
    n = e.shape[-1]
    r = sample_radial(generator, n, eps, tuple(e.shape[:-1]))
    v = sample_direction(generator, n, tuple(e.shape[:-1]))
    return Perturbation(e + r[..., None] * v, r, v)


def log_density_unnormalized(y, x, eps):
    """log D_{n,eps}(y | x) up to the (x-independent) normalizer."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32)
    return -float(eps) * torch.linalg.norm(y - x, dim=-1)


def dp_log_ratio(y, x, x_alt, eps):
    """L(K(x), K(x')) evaluated at y: must be <= eps * ||x - x'||."""
    return (log_density_unnormalized(y, x, eps)
            - log_density_unnormalized(y, x_alt, eps))


def radial_quantile_np(n: int, eps: float, q: float) -> float:
    """Host-side Gamma(n, 1/eps) quantile — used by the planner for robust k'."""
    import scipy.special as sps

    return float(sps.gammaincinv(n, q) / eps)


def expected_radius(n: int, eps: float) -> float:
    """E[r] = n / eps (paper: delta_alpha_k ~= r_bar = n/eps)."""
    return n / eps


def eps_for_radius(n: int, r: float) -> float:
    """Budget giving expected perturbation radius r."""
    return n / r


__all__ = [
    "Perturbation",
    "sample_gamma",
    "sample_radial",
    "sample_direction",
    "perturb",
    "log_density_unnormalized",
    "dp_log_ratio",
    "radial_quantile_np",
    "expected_radius",
    "eps_for_radius",
]
