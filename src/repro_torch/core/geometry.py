"""Hypersphere-cap geometry for RemoteRAG (paper Lemma 1, Theorems 1-3).

Counterpart of the host half of ``repro/core/geometry.py`` (numpy + scipy,
copied).  The reference's ``cap_fraction`` goes through
``jax.scipy.special.betainc``; here it is the scipy version.
"""

from __future__ import annotations

import numpy as np
import scipy.special as sps


def cap_fraction_np(alpha, n: int):
    """Fraction of S^{n-1} surface within polar angle ``alpha`` (float64)."""
    alpha = np.asarray(alpha, np.float64)
    s2 = np.clip(np.sin(alpha) ** 2, 0.0, 1.0)
    half = 0.5 * sps.betainc((n - 1) / 2.0, 0.5, s2)
    return np.where(alpha <= np.pi / 2, half, 1.0 - half)


cap_fraction = cap_fraction_np


def alpha_from_fraction_np(frac, n: int):
    """Inverse of :func:`cap_fraction_np` — polar angle containing fraction ``frac``."""
    frac = np.asarray(frac, np.float64)
    if np.any((frac < 0) | (frac > 1)):
        raise ValueError("cap fraction must be in [0, 1]")
    lower = np.minimum(frac, 1.0 - frac)  # solve on the <= pi/2 branch
    s2 = sps.betaincinv((n - 1) / 2.0, 0.5, np.clip(2.0 * lower, 0.0, 1.0))
    alpha = np.arcsin(np.sqrt(np.clip(s2, 0.0, 1.0)))
    return np.where(frac <= 0.5, alpha, np.pi - alpha)


def perturbed_angle(r, *, conservative: bool = False):
    """Angle between ``e_k`` and ``e_k + r*v`` for unit ``e_k``: ``r`` (the
    paper's small-r approximation) or, conservatively, ``arcsin(r)``."""
    r = np.asarray(r, np.float64)
    if conservative:
        return np.where(r < 1.0, np.arcsin(np.clip(r, 0.0, 1.0)), np.pi)
    return r


def kprime_for(k: int, N: int, n: int, r: float, *,
               conservative: bool = True, slack: float = 1.0) -> int:
    """Theorem 1: minimum k' so that top-k' of e_{k'} contains top-k of e_k."""
    if k <= 0:
        raise ValueError("k must be positive")
    if k >= N:
        return N
    alpha_k = float(alpha_from_fraction_np(k / N, n))
    d_alpha = float(perturbed_angle(r, conservative=conservative)) * slack
    alpha_kp = min(alpha_k + d_alpha, np.pi)
    kp = int(np.ceil(N * float(cap_fraction_np(alpha_kp, n))))
    return max(min(kp, N), k)


def delta_k(k: int, N: int, n: int, r: float, **kw) -> int:
    """Theorem 1 stated as the increment ``k' - k``."""
    return kprime_for(k, N, n, r, **kw) - k


def mean_angle_omega(alpha_k, k):
    """Theorem 3: mean angle between e_k and the mean of its top-k neighbours."""
    return np.arctan(np.tan(np.asarray(alpha_k, np.float64)) / np.sqrt(k))


def leakage_requires_ot(k: int, N: int, n: int, eps: float) -> bool:
    """Algorithm 2 line 7: OT needed iff omega < delta_alpha_mean (= n/eps)."""
    alpha_k = float(alpha_from_fraction_np(k / N, n))
    omega = float(mean_angle_omega(alpha_k, k))
    return omega < (n / eps)


__all__ = [
    "cap_fraction",
    "cap_fraction_np",
    "alpha_from_fraction_np",
    "perturbed_angle",
    "kprime_for",
    "delta_k",
    "mean_angle_omega",
    "leakage_requires_ot",
]
