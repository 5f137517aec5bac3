"""Frozen copy of the protocol planner's arithmetic (the paper's Lemma 1
and Theorems 1 and 3): exactly one of eps, radius or a k' knob gives the
privacy budget eps, the Theorem-1 search range k' and the module-2 path.
Copied from the port's ``core/planner.py`` and ``core/geometry.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.special as sps


@dataclasses.dataclass(frozen=True)
class Plan:
    eps: float
    kprime: int
    use_ot: bool


def cap_fraction(alpha, n: int):
    alpha = np.asarray(alpha, np.float64)
    s2 = np.clip(np.sin(alpha) ** 2, 0.0, 1.0)
    half = 0.5 * sps.betainc((n - 1) / 2.0, 0.5, s2)
    return np.where(alpha <= np.pi / 2, half, 1.0 - half)


def alpha_from_fraction(frac, n: int):
    frac = np.asarray(frac, np.float64)
    lower = np.minimum(frac, 1.0 - frac)
    s2 = sps.betaincinv((n - 1) / 2.0, 0.5, np.clip(2.0 * lower, 0.0, 1.0))
    alpha = np.arcsin(np.sqrt(np.clip(s2, 0.0, 1.0)))
    return np.where(frac <= 0.5, alpha, np.pi - alpha)


def perturbed_angle(r):
    """The conservative angle: arcsin(r) below 1, else pi."""
    r = np.asarray(r, np.float64)
    return np.where(r < 1.0, np.arcsin(np.clip(r, 0.0, 1.0)), np.pi)


def kprime_for(k: int, N: int, n: int, r: float) -> int:
    if k >= N:
        return N
    alpha_k = float(alpha_from_fraction(k / N, n))
    alpha_kp = min(alpha_k + float(perturbed_angle(r)), np.pi)
    kp = int(np.ceil(N * float(cap_fraction(alpha_kp, n))))
    return max(min(kp, N), k)


def radial_quantile(n: int, eps: float, q: float) -> float:
    return float(sps.gammaincinv(n, q) / eps)


def eps_for_kprime(n: int, N: int, k: int, kprime: int, q: float) -> float:
    if kprime >= N:
        return 1e-6
    lo, hi = 1.0, 1e9
    for _ in range(200):
        mid = np.sqrt(lo * hi)
        if kprime_for(k, N, n, radial_quantile(n, mid, q)) > kprime:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + 1e-3:
            break
    return float(np.sqrt(lo * hi))


def plan(*, n: int, N: int, k: int, eps: Optional[float] = None,
         radius: Optional[float] = None, kprime: Optional[int] = None,
         radial_q: float = 0.999) -> Plan:
    if sum(x is not None for x in (eps, radius, kprime)) != 1:
        raise ValueError("specify exactly one of eps / radius / kprime")
    if kprime is not None:
        eps = eps_for_kprime(n, N, k, kprime, radial_q)
    elif radius is not None:
        eps = n / radius
    kp = kprime_for(k, N, n, radial_quantile(n, eps, radial_q))
    alpha_k = float(alpha_from_fraction(k / N, n))
    omega = float(np.arctan(np.tan(alpha_k) / np.sqrt(k)))
    return Plan(eps=float(eps), kprime=int(kp), use_ot=bool(omega < n / eps))


def from_knob(knob: dict, *, n: int, N: int, k: int) -> Plan:
    """The plan of a configuration's ``plan`` entry: ``{"kprime": ...}``
    or ``{"radius": ...}``."""
    return plan(n=n, N=N, k=k, **{key: knob[key] for key in ("kprime",
                                                            "radius")
                                  if key in knob})
