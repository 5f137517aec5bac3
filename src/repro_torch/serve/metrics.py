"""Per-tenant serving metrics: latency percentiles + wire-byte accounting.

Counterpart of ``repro/serve/metrics.py`` over the port's
`ProtocolTranscript` (the module is framework-free; copied).

Latency is measured enqueue -> result (queue wait included, the number a
tenant actually experiences under micro-batching).  Wire bytes come from the
protocol transcripts, i.e. the same Request.nbytes / Reply.nbytes accounting
the paper's Table 2 uses.

Memory is bounded: latency and batch-size *samples* live in a fixed-size
sliding window (``window`` items, default 8192 — configurable through
`ServeMetrics` / ``EngineConfig.metrics_window``), so a long-lived engine
under the million-user north star cannot grow without bound.  Counts and
byte totals stay exact forever (they are plain integer accumulators);
`percentile`/`summary` statistics are computed over the current window.

Fault-isolation accounting (all exact integers): a lane pulled out of a
batched dispatch after fault attribution is *quarantined*
(``quarantined_lanes``); its solo retries are ``retried_requests`` and a
retry that succeeds is ``quarantined_retry_ok`` (also tracked per tenant, so
per-tenant error counts distinguish healed lanes from terminal
``errors``).  ``lane_encryptions`` counts every tenant-side query
encryption the engine performs; ``healthy_reencryptions`` counts
encryptions beyond the first for lanes that were never quarantined — the
isolation contract keeps it at zero.  ``dispatch_lanes`` accumulates
the lanes *completed* inside batched dispatches so `occupancy` reports
useful batch fill (a quarantined lane is lost fill, not a full batch);
refill-triggered dispatches are counted separately
(``refill_dispatches`` / ``refilled_requests``).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import threading
from typing import Deque, Dict, Optional

import numpy as np

from repro_torch.core.protocol import ProtocolTranscript

DEFAULT_WINDOW = 8192


def _locked(method):
    """Serialize a ServeMetrics method on the instance lock: replica
    engines record from their own step workers while the router thread
    reads summaries, and compound updates (tenant + aggregate + reason
    maps) must stay atomic across threads."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return wrapper


@dataclasses.dataclass
class TenantStats:
    """Exact integer totals + windowed latency/batch-size samples."""
    window: int = DEFAULT_WINDOW
    count: int = 0                 # exact: every recorded result
    errors: int = 0                # exact: terminal failures (retries spent)
    quarantined_retry_ok: int = 0  # exact: quarantined, healed on solo retry
    admitted: int = 0              # exact: submits past the admission tier
    shed: int = 0                  # exact: requests shed/rejected untried
    deadline_misses: int = 0       # exact: completions after their deadline
    request_bytes: int = 0
    reply_bytes: int = 0
    fetch_bytes: int = 0
    docs_bytes: int = 0
    ot_wire_bytes: int = 0
    direct_count: int = 0
    ot_count: int = 0
    latencies_s: Deque[float] = dataclasses.field(init=False, repr=False)
    batch_sizes: Deque[int] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        self.latencies_s = collections.deque(maxlen=self.window)
        self.batch_sizes = collections.deque(maxlen=self.window)

    @property
    def total_wire_bytes(self) -> int:
        return (self.request_bytes + self.reply_bytes + self.fetch_bytes
                + self.docs_bytes + self.ot_wire_bytes)

    def percentile(self, q: float) -> float:
        """Latency percentile over the current window (the trailing
        ``window`` results), not all-time.  NaN on an empty window — an
        error-only or untouched tenant has no latency samples, and that
        must read as "no data", not an opaque numpy error."""
        if not self.latencies_s:
            return math.nan
        return float(np.percentile(self.latencies_s, q))

    def summary(self) -> dict:
        if not self.latencies_s:
            # error-only (or untouched) stats: no samples to summarize —
            # percentile on an empty window must not blow up the summary
            out = {"count": self.count}
            if self.errors:
                out["errors"] = self.errors
            if self.quarantined_retry_ok:
                out["quarantined_retry_ok"] = self.quarantined_retry_ok
            self._admission_summary(out)
            return out
        out = {
            "count": self.count,
            "p50_latency_s": round(self.percentile(50), 4),
            "p99_latency_s": round(self.percentile(99), 4),
            "mean_latency_s": round(float(np.mean(self.latencies_s)), 4),
            "mean_batch_size": round(float(np.mean(self.batch_sizes)), 2),
            "mean_wire_kb": round(
                self.total_wire_bytes / max(self.count, 1) / 1024, 2),
            "paths": {"direct": self.direct_count, "ot": self.ot_count},
        }
        if self.errors:
            out["errors"] = self.errors
        if self.quarantined_retry_ok:
            out["quarantined_retry_ok"] = self.quarantined_retry_ok
        self._admission_summary(out)
        return out

    def _admission_summary(self, out: dict) -> None:
        """Admission-tier counters, surfaced only when the tier touched
        this tenant — a run without admission control keeps the exact
        historical summary shape."""
        if self.admitted:
            out["admitted"] = self.admitted
        if self.shed:
            out["shed"] = self.shed
        if self.deadline_misses:
            out["deadline_misses"] = self.deadline_misses


class ServeMetrics:
    """Accumulates TenantStats per tenant plus a process-wide aggregate.

    Dispatch-level accounting is exact-total + windowed-sample like the
    tenant stats: ``num_batches``/``dispatch_lanes``/``failed_dispatches``
    and the quarantine/refill counters are exact; ``dispatch_sizes`` keeps
    the trailing ``window`` batch sizes.  A batch is recorded only once the
    dispatch *completed for at least one lane* — a dispatch whose every
    lane failed calls `record_dispatch_failure` (never `record_batch`), so
    failed batches can never masquerade as served traffic, and a
    quarantined lane's solo retry is never recorded as a batch of its own
    (no phantom or duplicate batches).
    """

    def __init__(self, window: int = DEFAULT_WINDOW, *,
                 tracer=None) -> None:
        self._lock = threading.Lock()
        self.window = window
        # optional repro_torch.obs.Tracer: when attached (the engine does this
        # under EngineConfig(trace=True)), summary() carries the stage-
        # level telemetry snapshot alongside the tenant metrics
        self.tracer = tracer
        self.tenants: Dict[str, TenantStats] = {}
        self.aggregate = TenantStats(window=window)
        self.dispatch_sizes: Deque[int] = collections.deque(maxlen=window)
        self.num_batches = 0           # exact: completed dispatches
        self.dispatch_lanes = 0        # exact: lanes *completed* in batches
        self.failed_dispatches = 0     # exact: dispatches with zero lanes ok
        self.failed_requests = 0       # exact: requests in failed dispatches
        self.quarantined_lanes = 0     # exact: lanes isolated out of a batch
        self.retried_requests = 0      # exact: solo quarantine retries run
        self.quarantined_retry_ok = 0   # exact: solo retries that healed
        self.error_results = 0         # exact: error results handed back
        self.lane_encryptions = 0      # exact: tenant query encryptions
        self.healthy_reencryptions = 0  # exact: must stay 0 (contract)
        self.refill_dispatches = 0     # exact: dispatches on the refill path
        self.refilled_requests = 0     # exact: requests they carried
        # admission-tier accounting (all exact; zero and invisible in the
        # summary unless an admission tier / per-request deadline is used)
        self.admitted_requests = 0     # exact: submits past the tier
        self.shed_requests = 0         # exact: shed + rejected, all reasons
        self.shed_by_reason: Dict[str, int] = {}
        self.deadline_misses = 0       # exact: completions past deadline
        self.goodput_requests = 0      # exact: ok completions within SLO

    def _tenant(self, tenant: str) -> TenantStats:
        stats = self.tenants.get(tenant)
        if stats is None:
            stats = self.tenants[tenant] = TenantStats(window=self.window)
        return stats

    @_locked
    def record_batch(self, size: int, completed: Optional[int] = None) -> None:
        """One batched dispatch went out: ``size`` lanes in the slot, of
        which ``completed`` (default: all) actually finished there.
        `occupancy` reads the completed count, so a quarantined lane shows
        up as lost occupancy instead of hiding inside a full-looking
        batch."""
        self.num_batches += 1
        self.dispatch_lanes += size if completed is None else completed
        self.dispatch_sizes.append(size)

    @_locked
    def record_dispatch_failure(self, size: int) -> None:
        self.failed_dispatches += 1
        self.failed_requests += size

    @_locked
    def record_quarantined(self, n: int = 1) -> None:
        """n lanes were attributed a fault and pulled out of their batch."""
        self.quarantined_lanes += n

    @_locked
    def record_retries(self, n: int = 1) -> None:
        self.retried_requests += n

    @_locked
    def record_quarantined_retry_ok(self, tenant: str) -> None:
        """A quarantined lane healed on its solo retry (counted per tenant
        so error accounting distinguishes healed from terminal)."""
        self.quarantined_retry_ok += 1
        for stats in (self._tenant(tenant), self.aggregate):
            stats.quarantined_retry_ok += 1

    @_locked
    def record_encryptions(self, n: int = 1) -> None:
        self.lane_encryptions += n

    @_locked
    def record_healthy_reencryptions(self, n: int) -> None:
        """Encryptions beyond the first for a never-quarantined lane —
        wasted crypto the lane-isolation contract promises never happens."""
        self.healthy_reencryptions += n

    @_locked
    def record_refill(self, size: int) -> None:
        """One dispatch went out on the refill trigger (group credit)."""
        self.refill_dispatches += 1
        self.refilled_requests += size

    @_locked
    def record_error(self, tenant: str) -> None:
        """One request came back as an error result (retries exhausted)."""
        self.error_results += 1
        for stats in (self._tenant(tenant), self.aggregate):
            stats.errors += 1

    @_locked
    def record_admitted(self, tenant: str) -> None:
        """One submit passed the admission tier and was enqueued."""
        self.admitted_requests += 1
        for stats in (self._tenant(tenant), self.aggregate):
            stats.admitted += 1

    @_locked
    def record_shed(self, tenant: str, reason: str) -> None:
        """One request was shed (queued then displaced/expired) or
        rejected at submit (rate limit, full queue) — counted drops,
        keyed by the typed reason, so offered == completed + shed always
        reconciles."""
        self.shed_requests += 1
        self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
        for stats in (self._tenant(tenant), self.aggregate):
            stats.shed += 1

    @_locked
    def record(self, tenant: str, *, latency_s: float, batch_size: int,
               transcript: ProtocolTranscript,
               deadline_s: Optional[float] = None) -> None:
        # goodput = completions within their SLO; a request without a
        # deadline always counts (no SLO to miss), one past its deadline
        # is a deadline miss — completed, billed, but not goodput
        missed = deadline_s is not None and latency_s > deadline_s
        if missed:
            self.deadline_misses += 1
        else:
            self.goodput_requests += 1
        for stats in (self._tenant(tenant), self.aggregate):
            stats.count += 1
            if missed:
                stats.deadline_misses += 1
            stats.latencies_s.append(latency_s)
            stats.batch_sizes.append(batch_size)
            stats.request_bytes += transcript.request_bytes
            stats.reply_bytes += transcript.reply_bytes
            stats.fetch_bytes += transcript.fetch_bytes
            stats.docs_bytes += transcript.docs_bytes
            stats.ot_wire_bytes += transcript.ot_wire_bytes
            if transcript.path == "ot":
                stats.ot_count += 1
            else:
                stats.direct_count += 1

    @_locked
    def occupancy(self, max_batch: int) -> Optional[float]:
        """Mean *completed-lane* fill of batched dispatches relative to
        ``max_batch`` (1.0 = every batch went out full and every lane
        finished in it; quarantined lanes count as lost fill).  None
        before any batch completed."""
        if not self.num_batches or max_batch <= 0:
            return None
        return self.dispatch_lanes / (self.num_batches * max_batch)

    @_locked
    def summary(self) -> dict:
        out = {"aggregate": self.aggregate.summary(),
               "num_batches": self.num_batches,
               "dispatch_lanes": self.dispatch_lanes,
               "tenants": {t: s.summary() for t, s in self.tenants.items()}}
        # surfaced only when the admission tier (or a per-request
        # deadline) actually touched traffic: a default-config run keeps
        # the exact historical summary shape
        if (self.admitted_requests or self.shed_requests
                or self.deadline_misses):
            out["admission"] = {
                "admitted": self.admitted_requests,
                "shed": self.shed_requests,
                "shed_by_reason": dict(sorted(self.shed_by_reason.items())),
                "deadline_misses": self.deadline_misses,
                "goodput_requests": self.goodput_requests,
            }
        if self.refill_dispatches:
            out["refills"] = {
                "refill_dispatches": self.refill_dispatches,
                "refilled_requests": self.refilled_requests,
            }
        # healthy_reencryptions is part of the trigger: it is the
        # isolation contract, and a nonzero value must surface even when
        # every other failure counter is zero (a healthy-looking run that
        # silently re-encrypted would otherwise hide its contract breach)
        if (self.failed_dispatches or self.quarantined_lanes
                or self.error_results or self.healthy_reencryptions):
            out["failures"] = {
                "failed_dispatches": self.failed_dispatches,
                "failed_requests": self.failed_requests,
                "quarantined_lanes": self.quarantined_lanes,
                "retried_requests": self.retried_requests,
                "quarantined_retry_ok": self.quarantined_retry_ok,
                "error_results": self.error_results,
                "healthy_reencryptions": self.healthy_reencryptions,
            }
        if self.tracer is not None and getattr(self.tracer, "enabled",
                                               False):
            out["trace"] = self.tracer.snapshot()
        return out


__all__ = ["TenantStats", "ServeMetrics", "DEFAULT_WINDOW"]
