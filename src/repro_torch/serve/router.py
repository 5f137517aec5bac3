"""Scale-out serving: a replica router with scatter-gather top-k' (PyTorch).

Counterpart of ``repro/serve/router.py``.

`ReplicaRouter` fronts N `ServeEngine` replicas.  Each replica owns a
contiguous corpus slice (`FlatIndex.slice_view` over `plan_row_slices`,
aligned to the sharded candidate cache's shard size so slices and cache
shards share boundaries), its own admission controller, its own metrics
and its own replica-tagged tracer.  Tenants hash to a home replica
(`session.tenant_seed`, linear probing past quarantined replicas), so
submit load — admission checks, queueing, and the per-tenant crypto of
dispatch — spreads across the fleet while each tenant's rng stream still
advances in its own submit order (sessions are shared, so bit-identity
with a single engine is preserved).

Retrieval is scatter-gather: when a home replica's batch reaches its
top-k' stage, the perturbed embedding block fans out to *every* replica's
scan worker, each scanning only its slice (`topk.slice_topk`, global
ids), and the per-replica candidates are merged with a deterministic
tie-break — score descending, then global doc id ascending — which is
the tie order of the flat scan over the full corpus.  A score's bits
depend on its (query, row) pair alone (`kernels/scoretopk/ref.py`,
``csrc/scoretopk.cu``), so a slice scores its rows as the full corpus
does; the merged
candidate list is therefore bit-identical to a single engine's, whatever
the replica count or thread arrival order, and everything downstream
(encrypted re-rank, fetch/OT) is untouched.  The differential harness in
``tests/test_torch_router.py`` pins this end to end.

On one card every replica's step and scan threads launch on their
thread's current stream, the device's default stream, so the replicas'
kernels run in launch order; the threads overlap host work only.

Failure semantics (router tier, on top of the engine's lane-level
isolation): a replica whose step/scan raises or stalls past its timeout
is *quarantined* — taken out of scatter fan-out, submit homing, and
stepping.  Its in-flight requests are resolved from the router's
outstanding ledger as typed error results (``replica_quarantined(...)``,
``quarantined=True``) — never silently dropped — and late results from a
zombie replica thread are discarded and counted, so every request id
resolves exactly once.  Slice *data* is shared (every replica views one
index on one device), so a quarantined replica's slice keeps being scanned
by a fallback on the caller's thread: healthy replicas' results stay
bit-identical even while a peer is down.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.retrieval.index import FlatIndex, IndexSlice, plan_row_slices
from repro_torch.retrieval.topk import slice_topk
from repro_torch.serve import admission as adm
from repro_torch.serve.engine import EngineConfig, ServeEngine, ServeResult
from repro_torch.serve.session import Session, SessionManager, tenant_seed


class ReplicaUnavailable(adm.AdmissionError):
    """Every replica is quarantined: nothing can home this submit.  Typed
    into the `admission.AdmissionError` hierarchy so clients handle it
    like any other admission rejection — the request was never enqueued
    and no request id was consumed anywhere."""

    def __init__(self, num_replicas: int):
        super().__init__(
            f"all {num_replicas} replicas are quarantined; "
            f"no replica can accept submissions")
        self.num_replicas = num_replicas


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    num_replicas: int = 2
    # per-replica engine config (each replica gets its own admission
    # controller from this — the per-replica admitter seam)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    # a slice scan that raises — or exceeds this wall — quarantines its
    # replica; the slice is then served by the caller-thread fallback so
    # the in-flight batch still completes bit-identically.  None = wait
    # indefinitely (faults still quarantine, stalls never time out).
    scan_timeout_s: Optional[float] = None
    # a replica engine step()/drain() that raises — or exceeds this wall —
    # quarantines the replica; its in-flight requests resolve as typed
    # error results from the outstanding ledger.  None = no stall bound.
    step_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {self.num_replicas}")


class RouterMetrics:
    """Router-tier counters (thread-safe; replica workers record
    concurrently).  Everything is an exact integer — the router's
    zero-lost contract is audited as ``submitted == completed +
    quarantine_resolved`` per replica fleet-wide."""

    def __init__(self, num_replicas: int):
        self._lock = threading.Lock()
        self.num_replicas = num_replicas
        self.submitted = [0] * num_replicas     # accepted submits per home
        self.completed = [0] * num_replicas     # results returned per home
        self.rejected = [0] * num_replicas      # typed submit rejections
        self.rehomed = 0            # submits probed past a quarantined home
        self.scatter_calls = 0      # scatter-gather top-k' invocations
        self.slice_scans = 0        # per-replica slice scans completed
        self.fallback_scans = 0     # slices served by the caller fallback
        self.merged_candidates = 0  # candidate rows fed through the merge
        self.merge_wall_s = 0.0     # host time inside merge_topk
        self.quarantines: List[Tuple[int, str]] = []   # (replica, reason)
        self.quarantine_resolved = 0  # in-flight resolved as typed errors
        self.late_dropped = 0       # zombie-replica results discarded

    def record_submit(self, replica: int, *, rehomed: bool) -> None:
        with self._lock:
            self.submitted[replica] += 1
            if rehomed:
                self.rehomed += 1

    def record_rejected(self, replica: int) -> None:
        with self._lock:
            self.rejected[replica] += 1

    def record_completed(self, replica: int, n: int) -> None:
        with self._lock:
            self.completed[replica] += n

    def record_scatter(self, *, scans: int, fallbacks: int,
                       merged: int, merge_wall_s: float) -> None:
        with self._lock:
            self.scatter_calls += 1
            self.slice_scans += scans
            self.fallback_scans += fallbacks
            self.merged_candidates += merged
            self.merge_wall_s += merge_wall_s

    def record_quarantine(self, replica: int, reason: str,
                          resolved: int) -> None:
        with self._lock:
            self.quarantines.append((replica, reason))
            self.quarantine_resolved += resolved

    def record_late_dropped(self, n: int = 1) -> None:
        with self._lock:
            self.late_dropped += n

    def summary(self) -> dict:
        with self._lock:
            return {
                "num_replicas": self.num_replicas,
                "submitted": list(self.submitted),
                "completed": list(self.completed),
                "rejected": list(self.rejected),
                "rehomed": self.rehomed,
                "scatter_calls": self.scatter_calls,
                "slice_scans": self.slice_scans,
                "fallback_scans": self.fallback_scans,
                "merged_candidates": self.merged_candidates,
                "merge_wall_s": round(self.merge_wall_s, 6),
                "quarantines": [list(q) for q in self.quarantines],
                "quarantine_resolved": self.quarantine_resolved,
                "late_dropped": self.late_dropped,
            }


def merge_topk(values: Sequence[np.ndarray], ids: Sequence[np.ndarray],
               kprime: int) -> np.ndarray:
    """Merge per-replica top-k' candidates into the global (B, k') id
    block.

    Total order: score descending, then global doc id ascending — the
    tie-break the flat scan (stable, lower-index-first) produces over the
    full corpus, because global ids are assigned in row order and the
    full-index scan flattens tiles in row order too.  Host numpy: a
    selection, no arithmetic.  Duplicate scores
    across replicas therefore resolve exactly as a single engine would
    resolve them, and the result is independent of both the replica count
    and the order scan results arrived in (`np.lexsort` is a stable sort
    over deterministic inputs)."""
    vals = np.concatenate([np.asarray(v, np.float32) for v in values],
                          axis=1)
    gids = np.concatenate([np.asarray(i) for i in ids], axis=1)
    k = min(kprime, gids.shape[1])
    out = np.empty((gids.shape[0], k), gids.dtype)
    for lane in range(gids.shape[0]):
        order = np.lexsort((gids[lane], -vals[lane]))[:k]
        out[lane] = gids[lane][order]
    return out


class _ScatterSearcher:
    """The ``searcher`` injected into a replica's engine: binds the home
    replica id so scatter results/events are attributed to the home's
    tracer track.  Pure in (perturbed, kprime) — `_bisect_lanes` re-runs
    lane subsets through it during fault attribution."""

    __slots__ = ("router", "home")

    def __init__(self, router: "ReplicaRouter", home: int):
        self.router = router
        self.home = home

    def __call__(self, perturbed, kprime: int) -> np.ndarray:
        return self.router._scatter_topk(perturbed, kprime, home=self.home)


@dataclasses.dataclass
class _Replica:
    """One replica: an engine (compute + admission + queues), its slice,
    and two single-thread workers — `step_pool` runs the engine's
    dispatch, `scan_pool` answers scatter requests from *other* replicas'
    dispatches (separate pools, or two replicas could deadlock waiting on
    each other's busy step worker)."""
    replica_id: int
    engine: ServeEngine
    sl: IndexSlice
    step_pool: ThreadPoolExecutor
    scan_pool: ThreadPoolExecutor
    # request id -> (tenant, t_submit): the router's zero-lost ledger
    outstanding: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    quarantined: bool = False
    quarantine_reason: str = ""


class ReplicaRouter:
    """Front-end over N slice-owning `ServeEngine` replicas (see module
    docstring for the placement, scatter-gather and failure contracts).

    Bit-identity: results are identical — docs, ids, transcript bytes,
    request ids — to one `ServeEngine` over the whole corpus fed the same
    submissions in the same order, for any ``num_replicas``.  The
    replicas share the index (and its memoized candidate caches), the
    session manager, and one request-id counter; only the top-k' scan is
    sharded, and the merge reproduces the full scan's order exactly.

    A lane that gets quarantined *inside* an engine retries solo via the
    sequential path, but the engine threads its own searcher into that
    retry (`run_remoterag(..., topk_fn=...)`), so the retried top-k' goes
    through the same per-slice scan + merge as the scatter-gather path —
    slice-routed *and* bit-identical by construction.
    """

    def __init__(self, index: FlatIndex, *,
                 config: Optional[RouterConfig] = None,
                 sessions: Optional[SessionManager] = None,
                 clock=time.monotonic):
        self.config = config or RouterConfig()
        self.index = index
        self.sessions = (SessionManager(device=index.device)
                         if sessions is None else sessions)
        self.metrics = RouterMetrics(self.config.num_replicas)
        self._clock = clock
        self._ids = itertools.count()   # shared: rids are global submit order
        self._lock = threading.Lock()   # ledger + quarantine flags
        self._resolved: List[ServeResult] = []  # quarantine-synthesized
        self._closed = False
        # test seam: called with (replica_id) on the scan worker before a
        # slice scan runs — lets tests fuzz arrival order / inject faults
        self._scan_hook: Optional[Callable[[int], None]] = None

        ecfg = self.config.engine
        # pin the corpus at construction, like each engine does: slice
        # ownership is planned against this frozen view and only moves
        # when `replan` advances it after an ingest
        self.view = index.corpus_view()
        spans = self._plan_spans(self.view)
        self.replicas: List[_Replica] = []
        for r, (start, stop) in enumerate(spans):
            tracer = None
            if ecfg.trace:
                tracer = obs.Tracer(capacity=ecfg.trace_capacity,
                                    clock=clock, common={"replica": r})
            engine = ServeEngine(
                index, config=ecfg, sessions=self.sessions, clock=clock,
                tracer=tracer, request_ids=self._ids,
                searcher=_ScatterSearcher(self, r))
            self.replicas.append(_Replica(
                replica_id=r, engine=engine,
                sl=self.view.slice_view(start, stop),
                step_pool=ThreadPoolExecutor(
                    1, thread_name_prefix=f"replica{r}-step"),
                scan_pool=ThreadPoolExecutor(
                    1, thread_name_prefix=f"replica{r}-scan")))

    def _plan_spans(self, view) -> List[Tuple[int, int]]:
        """Slice ownership for ``view``'s rows.  With an IVF-built corpus
        the cuts land on *cluster* boundaries nearest an even row split —
        each replica owns whole clusters, so first-stage routing doubles
        as replica prediction, and (clusters being built shard-aligned)
        slices still share candidate-cache shard boundaries.  Without a
        cluster map this is the historical cache-aligned even split."""
        num_rows = view.num_rows
        nrep = self.config.num_replicas
        cm = view.cluster_map
        if cm is not None and cm.num_clusters >= nrep:
            stops = [int(s) for s in cm.stops]
            if stops[-1] != num_rows:       # defensive: cover a ragged tail
                stops.append(num_rows)
            # choose nrep-1 strictly increasing cluster boundaries, each
            # nearest its even-split target; stops[-1] (== num_rows) is
            # never a cut, so every replica gets at least one cluster
            cuts: List[int] = []
            prev = -1
            for r in range(1, nrep):
                target = num_rows * r / nrep
                lo = prev + 1
                hi = len(stops) - 2 - (nrep - 1 - r)
                j = min(range(lo, hi + 1),
                        key=lambda i: abs(stops[i] - target))
                cuts.append(stops[j])
                prev = j
            edges = [0] + cuts + [num_rows]
            return list(zip(edges[:-1], edges[1:]))
        ecfg = self.config.engine
        align = 1
        if ecfg.cache_config is not None:
            shard_docs = ecfg.cache_config.resolve_shard_docs(num_rows)
            if shard_docs * nrep <= num_rows:
                align = shard_docs
        return plan_row_slices(num_rows, nrep, align=align)

    def replan(self, epoch: Optional[int] = None) -> List[List[int]]:
        """Re-plan replica slice ownership from the corpus cluster map
        after an epoch advance (default: the index's current epoch).

        Slices swap atomically under the router lock and every healthy
        replica's engine re-pins its corpus view, so subsequent scatters
        cover the new rows and new sessions plan against (and are epoch-
        stamped with) the grown corpus.  The per-slice scan + (score desc,
        global id asc) merge is partition-independent, so results stay
        bit-identical to a single whole-corpus engine at the same epoch —
        the invariant the differential harness pins.  Call while quiesced
        (between step/drain calls): an engine mid-dispatch keeps the view
        it started with.  Returns the new ``[start, stop)`` spans."""
        if self._closed:
            raise RuntimeError("router is closed; cannot replan")
        view = self.index.corpus_view(epoch)
        spans = self._plan_spans(view)
        with self._lock:
            self.view = view
            for h, (start, stop) in zip(self.replicas, spans):
                h.sl = view.slice_view(start, stop)
        for h in self.replicas:
            if not h.quarantined:
                h.engine.refresh_corpus(view.epoch)
        return [[start, stop] for start, stop in spans]

    # -- sessions + submit ---------------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    def open_session(self, tenant: str, **session_kwargs) -> Session:
        # same epoch stamp as ServeEngine.open_session, from the router's
        # pinned view — a single engine and a router fed the same opens
        # therefore hit identical plan-cache keys
        session_kwargs.setdefault("epoch", self.view.epoch)
        return self.sessions.open(tenant, **session_kwargs)

    def home_replica(self, tenant: str) -> int:
        """The tenant's home replica id (hash placement, before probing)."""
        return tenant_seed(tenant) % self.num_replicas

    def _route(self, tenant: str) -> Tuple[_Replica, bool]:
        """Home replica for a submit: hash, then linear-probe past
        quarantined replicas.  Raises `ReplicaUnavailable` (a typed
        `AdmissionError`) when the whole fleet is down.  Caller holds
        ``self._lock``."""
        base = self.home_replica(tenant)
        for probe in range(self.num_replicas):
            h = self.replicas[(base + probe) % self.num_replicas]
            if not h.quarantined:
                return h, probe > 0
        raise ReplicaUnavailable(self.num_replicas)

    def submit(self, tenant: str, embedding: np.ndarray, key=None, *,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one query on the tenant's home replica.  Same contract
        as `ServeEngine.submit`: returns a request id; typed
        `admission.AdmissionError` rejections (including the home
        replica's `RateLimited` with its ``retry_after_s``) propagate
        unchanged, and a rejected submit consumed no request id on *any*
        replica — the id counter is shared and only advances on accept."""
        if self._closed:
            raise RuntimeError("router is closed; no further submissions")
        with self._lock:
            h, rehomed = self._route(tenant)
            try:
                rid = h.engine.submit(tenant, embedding, key,
                                      priority=priority,
                                      deadline_s=deadline_s)
            except adm.AdmissionError:
                self.metrics.record_rejected(h.replica_id)
                raise
            # ledger entry is written under the same lock as the submit, so
            # a quarantine firing from a replica worker can never slip in
            # between accept and ledger (which would orphan the result)
            h.outstanding[rid] = (tenant, self._clock())
        self.metrics.record_submit(h.replica_id, rehomed=rehomed)
        return rid

    @property
    def pending(self) -> int:
        return sum(h.engine.pending for h in self.replicas
                   if not h.quarantined)

    # -- scatter-gather top-k' ----------------------------------------------

    def _scan(self, replica_id: int, perturbed, kprime: int) -> tuple:
        """Exact top-k' over one replica's slice, global ids, as host
        arrays."""
        out = slice_topk(self.replicas[replica_id].sl, perturbed, kprime)
        return out.values.cpu().numpy(), out.indices.cpu().numpy()

    def _slice_scan(self, replica_id: int, perturbed, kprime: int) -> tuple:
        """One replica's share of a scatter.  Runs on the replica's scan
        worker."""
        hook = self._scan_hook
        if hook is not None:
            hook(replica_id)
        return self._scan(replica_id, perturbed, kprime)

    def _fallback_scan(self, replica_id: int, perturbed,
                       kprime: int) -> tuple:
        """Scan a quarantined replica's slice on the caller's thread.
        Slice data is shared (one index on one device), so this keeps
        in-flight and future batches on healthy replicas bit-identical
        while the owner is down (compute failed over, placement
        unchanged)."""
        return self._scan(replica_id, perturbed, kprime)

    def _scatter_topk(self, perturbed, kprime: int, *,
                      home: int) -> np.ndarray:
        """Fan a (B, n) perturbed block (a tensor on the index's device,
        or host numpy) out to every replica's slice and
        merge to the global (B, k') candidate ids.  Called from the home
        replica's dispatch (step worker); runs scans concurrently on the
        other replicas' scan workers and falls back inline for
        quarantined or failing slices."""
        cfg = self.config
        n = self.num_replicas
        with self._lock:
            down = [h.quarantined for h in self.replicas]
        futures: Dict[int, object] = {}
        for r in range(n):
            if not down[r]:
                futures[r] = self.replicas[r].scan_pool.submit(
                    self._slice_scan, r, perturbed, kprime)
        parts_v: List[np.ndarray] = [None] * n
        parts_i: List[np.ndarray] = [None] * n
        fallbacks = 0
        tracer = self.replicas[home].engine.tracer
        for r in range(n):
            fut = futures.get(r)
            if fut is not None:
                try:
                    parts_v[r], parts_i[r] = fut.result(
                        timeout=cfg.scan_timeout_s)
                    continue
                except FutureTimeoutError:
                    self._quarantine(r, "scan_stalled")
                except Exception as e:   # noqa: BLE001 — fault boundary
                    self._quarantine(r, f"scan:{type(e).__name__}")
            fallbacks += 1
            tracer.event("scan_fallback", shard=r)
            parts_v[r], parts_i[r] = self._fallback_scan(r, perturbed,
                                                         kprime)
        t0 = self._clock()
        merged = merge_topk(parts_v, parts_i, kprime)
        self.metrics.record_scatter(
            scans=n - fallbacks, fallbacks=fallbacks,
            merged=int(sum(p.size for p in parts_i)),
            merge_wall_s=self._clock() - t0)
        tracer.event("scatter", replicas=n - fallbacks, kprime=kprime,
                     lanes=perturbed.shape[0])
        return merged

    # -- quarantine + collection --------------------------------------------

    def _quarantine(self, replica_id: int, reason: str) -> None:
        """Take a replica out of service: no more homing, stepping, or
        scatter fan-out to it.  Every ledgered in-flight request resolves
        *now* as a typed error result (returned by the next step/drain) —
        the zero-lost contract at router scope.  Results the zombie
        replica produces later are dropped and counted (`_collect`)."""
        h = self.replicas[replica_id]
        with self._lock:
            if h.quarantined:
                return
            h.quarantined = True
            h.quarantine_reason = reason
            stranded = sorted(h.outstanding.items())
            h.outstanding.clear()
        now = self._clock()
        resolved = [
            ServeResult(
                request_id=rid, tenant=tenant, docs=[],
                ids=np.empty(0, np.int64), transcript=None,
                latency_s=now - t_submit, batch_size=0,
                error=f"replica_quarantined({reason})", quarantined=True)
            for rid, (tenant, t_submit) in stranded]
        with self._lock:
            self._resolved.extend(resolved)
        self.metrics.record_quarantine(replica_id, reason, len(resolved))
        h.engine.tracer.event("replica_quarantine", reason=reason[:64],
                              requests=len(resolved))

    def _collect(self, h: _Replica,
                 results: List[ServeResult]) -> List[ServeResult]:
        """Reconcile a replica's step/drain output against the ledger:
        each request id resolves exactly once — a result whose id was
        already resolved at quarantine time is a zombie duplicate and is
        dropped (counted, never returned twice)."""
        kept = []
        late = 0
        with self._lock:
            for res in results:
                if h.outstanding.pop(res.request_id, None) is None:
                    late += 1
                    continue
                kept.append(res)
        if late:
            self.metrics.record_late_dropped(late)
        self.metrics.record_completed(h.replica_id, len(kept))
        return kept

    def _take_resolved(self) -> List[ServeResult]:
        with self._lock:
            out, self._resolved = self._resolved, []
        return out

    def _run_on_replicas(self, call, *, timeout: Optional[float],
                         label: str) -> List[ServeResult]:
        """Run ``call(engine)`` on every healthy replica's step worker in
        parallel, collecting through the ledger; a raise or stall
        quarantines that replica."""
        out = self._take_resolved()
        with self._lock:
            healthy = [h for h in self.replicas if not h.quarantined]
        futures = [(h, h.step_pool.submit(call, h.engine)) for h in healthy]
        for h, fut in futures:
            try:
                results = fut.result(timeout=timeout)
            except FutureTimeoutError:
                self._quarantine(h.replica_id, f"{label}_stalled")
                continue
            except Exception as e:       # noqa: BLE001 — fault boundary
                self._quarantine(h.replica_id, f"{label}:{type(e).__name__}")
                continue
            out.extend(self._collect(h, results))
        out.extend(self._take_resolved())
        return out

    # -- dispatch ------------------------------------------------------------

    def step(self, *, force: bool = False) -> List[ServeResult]:
        """Step every healthy replica once, in parallel (each replica
        dispatches at most one batch, per `ServeEngine.step`).  Returns
        completed/shed results plus any quarantine-resolved errors."""
        return self._run_on_replicas(
            lambda eng: eng.step(force=force),
            timeout=self.config.step_timeout_s, label="step")

    def drain(self, *, shed: bool = False) -> List[ServeResult]:
        """Flush every healthy replica (`ServeEngine.drain`); results in
        request order.  Quarantine-resolved error results ride along, so
        ledger accounting holds: every accepted submit resolves exactly
        once across step/drain calls."""
        out = self._run_on_replicas(
            lambda eng: eng.drain(shed=shed),
            timeout=self.config.step_timeout_s, label="drain")
        return sorted(out, key=lambda r: r.request_id)

    # -- telemetry + lifecycle ----------------------------------------------

    def summary(self) -> dict:
        """Router counters + per-replica engine summaries (JSON-ready)."""
        return {
            "router": self.metrics.summary(),
            "epoch": self.view.epoch,
            "slices": [[h.sl.start, h.sl.stop] for h in self.replicas],
            "quarantined": {
                str(h.replica_id): h.quarantine_reason
                for h in self.replicas if h.quarantined},
            "replicas": {str(h.replica_id): h.engine.metrics.summary()
                         for h in self.replicas},
        }

    def write_trace(self, path: str) -> int:
        """Merge every replica's span ring into one Chrome-trace timeline
        (spans carry a ``replica`` attr; see obs.trace)."""
        if not self.config.engine.trace:
            raise RuntimeError(
                "tracing is disabled; construct the router with "
                "RouterConfig(engine=EngineConfig(trace=True))")
        spans = []
        for h in self.replicas:
            spans.extend(h.engine.tracer.spans())
        spans.sort(key=lambda s: s.t_start)
        return obs.write_chrome_trace(path, spans)

    def close(self, *, shed_pending: bool = False) -> List[ServeResult]:
        """Drain, close every healthy replica engine (idempotent; the
        shared candidate cache's admitter stops with the last closer), and
        shut the worker pools down.  Quarantined replicas are not drained
        — their requests already resolved at quarantine time."""
        if self._closed:
            return []
        out = self.drain(shed=shed_pending)
        self._closed = True
        with self._lock:
            healthy = [h for h in self.replicas if not h.quarantined]
        for h in healthy:
            try:
                h.step_pool.submit(h.engine.close).result(
                    timeout=self.config.step_timeout_s)
            except Exception:            # noqa: BLE001 — already leaving
                pass
        for h in self.replicas:
            h.step_pool.shutdown(wait=False)
            h.scan_pool.shutdown(wait=False)
        return out

    def __enter__(self) -> "ReplicaRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


__all__ = ["RouterConfig", "RouterMetrics", "ReplicaRouter",
           "ReplicaUnavailable", "merge_topk"]
