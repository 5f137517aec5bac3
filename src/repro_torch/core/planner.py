"""Privacy/efficiency planner for RemoteRAG.

Turns user-facing knobs (privacy budget eps, or a target perturbation radius r,
or a target candidate count k') into a concrete protocol plan:

  * the perturbation radius the mechanism will use (mean or quantile),
  * the inflated search range k' (Theorem 1),
  * the module-2 retrieval path (direct indices vs k-out-of-k' OT, Theorem 3),
  * predicted communication cost (paper Table 2).

The paper's guideline eps in [10n, 50n] corresponds to mean radii in
[0.02, 0.1]; both parameterizations are supported (Fig. 6b does k' -> eps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import distancedp, geometry


@dataclasses.dataclass(frozen=True)
class ProtocolPlan:
    n: int                # embedding dimension
    N: int                # corpus size
    k: int                # requested top-k
    eps: float            # privacy budget
    radius: float         # perturbation radius used for Theorem-1 planning
    radial_quantile: float
    delta_alpha: float    # planned perturbed angle
    alpha_k: float        # Lemma-1 polar angle of the top-k cap
    kprime: int           # Theorem-1 inflated search range
    omega: float          # Theorem-3 mean-embedding leakage angle
    use_ot: bool          # module 2(c) if True else 2(b)
    conservative: bool

    @property
    def path(self) -> str:
        return "ot" if self.use_ot else "direct"


def plan(
    *,
    n: int,
    N: int,
    k: int,
    eps: Optional[float] = None,
    radius: Optional[float] = None,
    kprime: Optional[int] = None,
    radial_quantile: float = 0.999,
    conservative: bool = True,
    slack: float = 1.0,
) -> ProtocolPlan:
    """Build a protocol plan from exactly one of (eps, radius, kprime).

    ``radial_quantile`` plans k' against a high quantile of Gamma(n, 1/eps)
    instead of its mean, so the Theorem-1 containment holds w.p. ~quantile
    per request even before the conservative-angle slack.
    """
    provided = sum(x is not None for x in (eps, radius, kprime))
    if provided != 1:
        raise ValueError("specify exactly one of eps / radius / kprime")
    if kprime is not None:
        eps = eps_for_kprime(n=n, N=N, k=k, kprime=kprime,
                             radial_quantile=radial_quantile,
                             conservative=conservative, slack=slack)
    elif radius is not None:
        eps = distancedp.eps_for_radius(n, radius)
    assert eps is not None

    r_plan = distancedp.radial_quantile_np(n, eps, radial_quantile)
    alpha_k = float(geometry.alpha_from_fraction_np(k / N, n))
    d_alpha = float(geometry.perturbed_angle(r_plan, conservative=conservative)) * slack
    kp = geometry.kprime_for(k, N, n, r_plan, conservative=conservative, slack=slack)
    omega = float(geometry.mean_angle_omega(alpha_k, k))
    # Theorem 3 / Algorithm 2: compare against the *mean* perturbation angle,
    # as the paper does (delta_alpha ~= n/eps).
    use_ot = omega < (n / eps)
    return ProtocolPlan(
        n=n, N=N, k=k, eps=float(eps), radius=float(r_plan),
        radial_quantile=radial_quantile, delta_alpha=d_alpha, alpha_k=alpha_k,
        kprime=int(kp), omega=omega, use_ot=bool(use_ot),
        conservative=conservative,
    )


def eps_for_kprime(
    *,
    n: int,
    N: int,
    k: int,
    kprime: int,
    radial_quantile: float = 0.999,
    conservative: bool = True,
    slack: float = 1.0,
    tol: float = 1e-3,
) -> float:
    """Fig. 6(b): the privacy budget whose plan yields the target k' (bisection)."""
    if kprime < k:
        raise ValueError("kprime must be >= k")
    if kprime >= N:
        return 1e-6  # effectively eps -> 0: privacy-conscious limit

    def kp_of(eps: float) -> int:
        r = distancedp.radial_quantile_np(n, eps, radial_quantile)
        return geometry.kprime_for(k, N, n, r, conservative=conservative, slack=slack)

    lo, hi = 1.0, 1e9  # eps: small -> huge k', large -> k' ~= k
    for _ in range(200):
        mid = np.sqrt(lo * hi)
        if kp_of(mid) > kprime:
            lo = mid
        else:
            hi = mid
        if hi / lo < 1 + tol:
            break
    return float(np.sqrt(lo * hi))


__all__ = ["ProtocolPlan", "plan", "eps_for_kprime"]
