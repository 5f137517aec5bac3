"""SLO-aware admission control for the serving engine.

The paper's headline number is a *per-query* retrieval SLO (0.67 s at 10^6
docs); a multi-tenant cloud service meets it only if overload is handled
*before* the expensive work runs.  Every request the engine accepts spends
DistanceDP perturbation, an RLWE query encryption, and a batched encrypted
re-rank — so a request that is going to miss its deadline anyway, or a
tenant bursting past its contract, must be rejected at the door (typed
backpressure) or shed from the queue (typed shed results), never silently
queued into a latency collapse.

Three mechanisms, all off by default (``EngineConfig(admission=None)`` is
bit-identical to the uncontrolled engine):

* **Per-tenant token buckets** (``tenant_rate`` / ``tenant_burst``,
  per-tenant overrides via ``tenant_rates``): `ServeEngine.submit` raises
  `RateLimited` — with a ``retry_after_s`` hint — before the request is
  enqueued.
* **A bounded global queue with counted drops** (``max_queue``, the same
  bounded-queue idiom as the shard admitter's admission queue): when the
  queue is full a new request either evicts a strictly lower-priority
  queued request (which is resolved as a shed result — never lost) or is
  rejected with `QueueFull`.
* **Deadline-aware shedding** (``default_deadline_s`` or per-request
  ``deadline_s``): at every batch-formation step, a queued request whose
  remaining budget cannot cover the group's *observed* p50 dispatch
  latency — measured by a per-group `repro_torch.obs.StageHistogram`, the same
  bounded histogram the tracer uses — is resolved as a
  ``ServeResult(shed_reason="deadline")`` before any crypto runs.

Priority classes (`PRIORITIES`: interactive > batch > best_effort) order
both *eviction* (best-effort is displaced first) and *dispatch* (each
group's queue pops interactive lanes first), so interactive traffic
degrades last under overload.

`submit`'s precondition failures are part of the same typed hierarchy:
`UnknownTenant` (also a ``KeyError``) and `InvalidEmbedding` (also a
``ValueError``), so clients catch one `AdmissionError` base for every
admission-tier rejection.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, Iterator, List, Mapping, Optional, Tuple

from repro_torch.obs import StageHistogram

# Priority classes, best first: eviction walks the tuple from the right,
# dispatch pops from the left — interactive degrades last either way.
PRIORITIES: Tuple[str, ...] = ("interactive", "batch", "best_effort")

# Typed shed reasons (`ServeResult.shed_reason` vocabulary)
SHED_DEADLINE = "deadline"        # remaining budget < observed p50 dispatch
SHED_QUEUE_FULL = "queue_full"    # bounded queue displaced/rejected it
SHED_RATE_LIMITED = "rate_limited"  # tenant token bucket was empty
SHED_SHUTDOWN = "shutdown"        # engine shut down with it still queued
SHED_REASONS = frozenset({SHED_DEADLINE, SHED_QUEUE_FULL,
                          SHED_RATE_LIMITED, SHED_SHUTDOWN})


def priority_rank(priority: str) -> int:
    """0 = degrades last.  Unknown classes are a caller bug, not a shed."""
    try:
        return PRIORITIES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority {priority!r}; must be one of {PRIORITIES}"
        ) from None


# ---------------------------------------------------------------------------
# typed rejection hierarchy
# ---------------------------------------------------------------------------

class AdmissionError(Exception):
    """Base of every typed `submit` rejection.  Nothing raising this has
    been enqueued — no crypto ran, no request id was assigned, and the
    client may retry (see `RateLimited.retry_after_s`) or downgrade."""


class UnknownTenant(AdmissionError, KeyError):
    """No open session for the tenant.  Subclasses ``KeyError`` so existing
    callers that caught the untyped rejection keep working."""

    def __init__(self, tenant: str):
        super().__init__(f"no open session for tenant {tenant!r}; call "
                         f"open_session first")
        self.tenant = tenant

    def __str__(self) -> str:         # KeyError would repr-quote the message
        return self.args[0]


class InvalidEmbedding(AdmissionError, ValueError):
    """Malformed query embedding (wrong rank).  Subclasses ``ValueError``
    so existing callers keep working."""


class QueueFull(AdmissionError):
    """The bounded global queue is full and no strictly lower-priority
    request could be displaced for this one."""

    def __init__(self, tenant: str, queued: int, bound: int):
        super().__init__(
            f"queue full ({queued} queued >= max_queue={bound}) and no "
            f"lower-priority request to displace for tenant {tenant!r}")
        self.tenant = tenant
        self.queued = queued
        self.bound = bound


class RateLimited(AdmissionError):
    """The tenant's token bucket is empty.  ``retry_after_s`` is the
    earliest time a single token will be available again."""

    def __init__(self, tenant: str, retry_after_s: float):
        super().__init__(f"tenant {tenant!r} is rate limited; retry in "
                         f"{retry_after_s:.3f}s")
        self.tenant = tenant
        self.retry_after_s = retry_after_s


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Request-tier admission knobs (``EngineConfig.admission``).

    Every field defaults to "off"; an engine built with ``admission=None``
    has no admission tier at all and behaves bit-identically to the
    uncontrolled engine.
    """
    # per-tenant token bucket: sustained requests/s (None = unlimited) and
    # bucket depth (None = max(1, tenant_rate)); tenant_rates overrides the
    # default rate for named tenants (0 = block the tenant entirely)
    tenant_rate: Optional[float] = None
    tenant_burst: Optional[float] = None
    tenant_rates: Optional[Mapping[str, float]] = None
    # bounded global queue across all groups (None = unbounded); a full
    # queue displaces strictly lower-priority work or rejects (QueueFull)
    max_queue: Optional[int] = None
    # deadline applied to requests that don't pass their own deadline_s
    # (None = no default; requests without a deadline are never shed for
    # deadline reasons and always count toward goodput)
    default_deadline_s: Optional[float] = None
    # deadline-aware shedding at batch formation: shed a queued request
    # whose remaining budget < the group's observed p50 dispatch latency
    shed_deadlines: bool = True
    # priority class given to submits that don't name one
    default_priority: str = "interactive"

    def __post_init__(self):
        if self.tenant_rate is not None and self.tenant_rate < 0:
            raise ValueError(f"tenant_rate must be >= 0, got "
                             f"{self.tenant_rate}")
        if self.tenant_burst is not None and self.tenant_burst <= 0:
            raise ValueError(f"tenant_burst must be > 0, got "
                             f"{self.tenant_burst}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if (self.default_deadline_s is not None
                and self.default_deadline_s <= 0):
            raise ValueError(f"default_deadline_s must be > 0, got "
                             f"{self.default_deadline_s}")
        priority_rank(self.default_priority)     # validate eagerly


# ---------------------------------------------------------------------------
# token bucket
# ---------------------------------------------------------------------------

class TokenBucket:
    """Classic token bucket on an injected monotonic clock (the engine's,
    so fake-clock tests and the deadline math share one timeline)."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def retry_after_s(self) -> float:
        """Seconds until one token is available (inf for a zero rate)."""
        if self.rate <= 0:
            return float("inf")
        return max(0.0, (1.0 - self.tokens) / self.rate)


# ---------------------------------------------------------------------------
# priority-classed group queue
# ---------------------------------------------------------------------------

class GroupQueue:
    """FIFO per priority class for one (backend, n, k') group.

    Dispatch pops in priority order (interactive first, FIFO within a
    class); triggers read the *oldest* head across classes so a waiting
    best-effort request still fires the deadline trigger.  With a single
    class in use this is exactly the plain FIFO deque it replaced.
    """

    __slots__ = ("_ranks",)

    def __init__(self) -> None:
        self._ranks: Tuple[Deque, ...] = tuple(
            collections.deque() for _ in PRIORITIES)

    def append(self, req) -> None:
        self._ranks[req.rank].append(req)

    def __len__(self) -> int:
        return sum(len(d) for d in self._ranks)

    def __bool__(self) -> bool:
        return any(self._ranks)

    def __iter__(self) -> Iterator:
        for d in self._ranks:
            yield from d

    def oldest_enqueue(self) -> float:
        """Enqueue time of the oldest queued request across all classes
        (the deadline-trigger clock must not starve low priorities)."""
        return min(d[0].t_enqueue for d in self._ranks if d)

    def head_rank(self) -> int:
        """Rank of the best-priority nonempty class (dispatch order)."""
        for rank, d in enumerate(self._ranks):
            if d:
                return rank
        raise IndexError("head_rank of empty GroupQueue")

    def pop_batch(self, n: int) -> List:
        """Pop up to ``n`` requests, priority order first, FIFO within."""
        out: List = []
        for d in self._ranks:
            while d and len(out) < n:
                out.append(d.popleft())
        return out

    def worst(self) -> Optional[Tuple[int, object]]:
        """(rank, request) of the *youngest request of the worst class*
        present — the displacement victim candidate — or None if empty."""
        for rank in range(len(self._ranks) - 1, -1, -1):
            if self._ranks[rank]:
                return rank, self._ranks[rank][-1]
        return None

    def remove(self, req) -> None:
        self._ranks[req.rank].remove(req)

    def shed(self, pred) -> List:
        """Remove and return every queued request matching ``pred``
        (FIFO order preserved for the survivors)."""
        out: List = []
        for rank, d in enumerate(self._ranks):
            if not d:
                continue
            keep = collections.deque()
            for req in d:
                (out if pred(req) else keep).append(req)
            self._ranks[rank].clear()
            self._ranks[rank].extend(keep)
        return out


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class AdmissionController:
    """Decision core behind `ServeEngine.submit`/`step` when
    ``EngineConfig.admission`` is set.  Owns the per-tenant token buckets
    and the per-group dispatch-latency histograms; the engine owns the
    queues and resolves the shed results."""

    def __init__(self, config: AdmissionConfig, *, clock) -> None:
        self.config = config
        self._clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        # per-(backend, n, k') dispatch-wall histograms — the same bounded
        # StageHistogram the tracer folds stage spans into, but always on
        # (shedding must work with tracing off)
        self._dispatch: Dict[tuple, StageHistogram] = {}

    # -- rate limiting ------------------------------------------------------

    def _rate_for(self, tenant: str) -> Optional[float]:
        overrides = self.config.tenant_rates
        if overrides is not None and tenant in overrides:
            return overrides[tenant]
        return self.config.tenant_rate

    def check_rate(self, tenant: str, now: float) -> Optional[float]:
        """None if admitted; otherwise the retry-after hint in seconds."""
        rate = self._rate_for(tenant)
        if rate is None:
            return None
        if rate <= 0:            # a zero rate blocks the tenant outright
            return float("inf")  # (no default burst token to spend)
        bucket = self._buckets.get(tenant)
        if bucket is None or bucket.rate != rate:
            burst = (self.config.tenant_burst
                     if self.config.tenant_burst is not None
                     else max(1.0, rate))
            bucket = self._buckets[tenant] = TokenBucket(rate, burst, now)
        if bucket.try_take(now):
            return None
        return bucket.retry_after_s()

    # -- deadline estimation -------------------------------------------------

    def observe_dispatch(self, group: tuple, duration_s: float) -> None:
        hist = self._dispatch.get(group)
        if hist is None:
            hist = self._dispatch[group] = StageHistogram()
        hist.record(duration_s)

    def dispatch_estimate(self, group: tuple) -> Optional[float]:
        """Observed p50 dispatch wall for the group (bucket upper-edge, so
        biased up to one log2 bucket high — shedding errs on the side of
        rejecting a doomed request early).  None before any dispatch."""
        hist = self._dispatch.get(group)
        if hist is None or not hist.count:
            return None
        return hist.percentile(50)

    def should_shed(self, req, now: float) -> bool:
        """Deadline-aware shed decision for one *queued* request: its
        remaining budget has expired outright, or cannot cover the group's
        observed p50 dispatch latency (no estimate -> optimistic: only
        outright expiry sheds)."""
        if req.deadline_s is None:
            return False
        remaining = req.t_enqueue + req.deadline_s - now
        if remaining <= 0.0:
            return True
        est = self.dispatch_estimate(req.group)
        return est is not None and remaining < est

    def summary(self) -> dict:
        """JSON-ready controller state (estimates only; the shed/admit
        counters live in `ServeMetrics`)."""
        return {
            "tenant_buckets": len(self._buckets),
            "dispatch_p50_s": {
                "/".join(map(str, g)): round(h.percentile(50), 6)
                for g, h in self._dispatch.items() if h.count},
        }


__all__ = [
    "PRIORITIES", "priority_rank",
    "SHED_DEADLINE", "SHED_QUEUE_FULL", "SHED_RATE_LIMITED",
    "SHED_SHUTDOWN", "SHED_REASONS",
    "AdmissionError", "UnknownTenant", "InvalidEmbedding", "QueueFull",
    "RateLimited",
    "AdmissionConfig", "TokenBucket", "GroupQueue", "AdmissionController",
]
