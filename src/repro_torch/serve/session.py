"""Per-tenant sessions and the protocol-plan cache (PyTorch port).

Counterpart of ``repro/serve/session.py``.  A Session owns everything the
protocol calls "the user": the tenant's secret key material (RLWE, on
the manager's device, or Paillier), its numpy RNG stream, and its
ProtocolPlan.  The RNG stream is the reference's (`tenant_seed` under
deterministic seeds), so two managers, one per package, replay
bit-identical keys and ciphertexts.
Plans are pure functions of the planning knobs, so a process-wide PlanCache
lets repeat tenants (or many tenants with the same service tier) skip the
Theorem-1 bisection + scipy quantile work entirely.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core import planner, protocol
from repro_torch.core.planner import ProtocolPlan
from repro_torch.crypto import rlwe
from repro_torch.device import DeviceLike, resolve_device


class PlanCache:
    """Memoize planner.plan on (n, N, k, eps/radius, plan kwargs) — exactly
    the arguments the planner consumes, so tenants that differ only in
    crypto backend share one plan.

    Entries are additionally stamped with the corpus ``epoch`` they were
    planned against: N (the Theorem-1 corpus size) changes when ingestion
    advances the epoch, and the stamp makes a stale plan unreachable even
    for a hypothetical ingest that leaves N unchanged — the serve layer
    passes its pinned `CorpusView.epoch` here."""

    def __init__(self) -> None:
        self._plans: Dict[tuple, ProtocolPlan] = {}
        self.hits = 0
        self.misses = 0

    def get(self, *, n: int, N: int, k: int, eps: Optional[float] = None,
            radius: Optional[float] = None, epoch: int = 0,
            **plan_kwargs) -> ProtocolPlan:
        key = (n, N, k, eps, radius, epoch,
               tuple(sorted(plan_kwargs.items())))
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        plan = planner.plan(n=n, N=N, k=k, eps=eps, radius=radius,
                            **plan_kwargs)
        self._plans[key] = plan
        return plan

    def __len__(self) -> int:
        return len(self._plans)


def tenant_seed(tenant: str) -> int:
    """Stable per-tenant RNG seed (so two engines replay identical streams).

    Derivable from the public tenant id — only safe under
    ``SessionManager(deterministic_seeds=True)`` replay/benchmark setups,
    never as a production default (the key material would be public).
    """
    return int.from_bytes(hashlib.sha256(tenant.encode()).digest()[:8], "big")


@dataclasses.dataclass
class Session:
    tenant: str
    user: protocol.RemoteRagUser
    created_at: float
    knobs: tuple = ()              # the open() arguments that built this
    num_requests: int = 0
    # serializes the tenant's rng-consuming protocol stages (query
    # encryption, OT retrieval): the engine's background retry lane may
    # run a quarantined request for this tenant concurrently with a
    # dispatch batch, and the numpy Generator must advance one draw at a
    # time to keep streams well-defined
    lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def backend(self) -> str:
        return self.user.backend

    @property
    def plan(self) -> ProtocolPlan:
        return self.user.plan


class SessionManager:
    """Tenant registry: one Session per tenant id, shared RLWE public params
    (each tenant still generates its own secret key).  Keys live on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, *, rlwe_params: Optional[rlwe.RlweParams] = None,
                 plan_cache: Optional[PlanCache] = None,
                 deterministic_seeds: bool = False,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.rlwe_params = (rlwe.RlweParams() if rlwe_params is None
                            else rlwe_params)
        # `is None` (not truthiness): an empty PlanCache has len 0 == falsy
        self.plan_cache = PlanCache() if plan_cache is None else plan_cache
        # True: per-tenant rng seeded from tenant_seed(name) so two engines
        # replay identical key/noise streams (parity tests, benchmarks).
        # False (default): OS entropy — tenant keys are not derivable.
        self.deterministic_seeds = deterministic_seeds
        self._sessions: Dict[str, Session] = {}

    def get(self, tenant: str) -> Session:
        return self._sessions[tenant]

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    def open(self, tenant: str, *, n: int, N: int, k: int,
             eps: Optional[float] = None, radius: Optional[float] = None,
             backend: str = "rlwe", seed: Optional[int] = None,
             paillier_bits: int = 512, epoch: int = 0,
             plan_kwargs: Optional[dict] = None) -> Session:
        """Create (or return) the tenant's session.  Keygen happens here,
        once; the plan comes from the shared cache.  Re-opening an existing
        tenant with *different* knobs is an error — the old plan would keep
        being used silently (e.g. a stale, weaker privacy budget).
        ``epoch`` stamps the plan-cache entry with the corpus epoch the
        caller planned against (see `PlanCache`)."""
        knobs = (n, N, k, eps, radius, backend, seed, paillier_bits,
                 tuple(sorted((plan_kwargs or {}).items())))
        if tenant in self._sessions:
            sess = self._sessions[tenant]
            if sess.knobs != knobs:
                raise ValueError(
                    f"tenant {tenant!r} already open with different knobs "
                    f"{sess.knobs}; close/rename the session to change them")
            return sess
        plan = self.plan_cache.get(n=n, N=N, k=k, eps=eps, radius=radius,
                                   epoch=epoch, **(plan_kwargs or {}))
        if seed is None and self.deterministic_seeds:
            seed = tenant_seed(tenant)
        rng = np.random.default_rng(seed)  # seed None -> OS entropy
        user = protocol.RemoteRagUser(
            n=n, N=N, k=k, backend=backend, plan=plan,
            rlwe_params=self.rlwe_params, paillier_bits=paillier_bits,
            rng=rng, device=self.device)
        sess = Session(tenant=tenant, user=user,
                       created_at=time.monotonic(), knobs=knobs)
        self._sessions[tenant] = sess
        return sess


__all__ = ["PlanCache", "Session", "SessionManager", "tenant_seed"]
