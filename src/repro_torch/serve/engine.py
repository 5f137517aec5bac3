"""Micro-batching request engine for the RemoteRAG protocol (PyTorch port).

Counterpart of ``repro/serve/engine.py``, on the index's device (``cuda``
unless the index was built on ``cpu``).  The reference's ``use_pallas``
switch has no counterpart: the tensors' device picks kernel or plain
version.  A request's DistanceDP noise comes from a `torch.Generator`
seeded with the request's ``key`` (an integer; OS entropy by default).

Requests enqueue via `submit`; `step` forms at most one batch per call using
three triggers — size (a compatible group reached `max_batch`), deadline
(the group's oldest request waited `max_wait_s`), and refill (the group's
previous batch dispatched under `max_batch`, or full with a burst tail
still queued, so waiting requests are admitted into the next dispatch
immediately instead of waiting out the deadline again) — and runs the
full protocol for that batch:

  module 1    batched DistanceDP perturbation (per-request generators)
  module 2a   ONE batched score-top-k' kernel invocation over the shared
              index (run first, so sharded-cache shard admissions can be
              prefetched from the candidate ids — the admitter's copy on
              its own CUDA stream overlaps the per-tenant encryption that
              follows), then per-tenant query encryption, one batched
              encrypted re-rank and one batched decryption through the
              crypto-backend seam (`repro_torch.crypto.backend`) — RLWE
              scores against the index's NTT-domain candidate cache; the
              stage pipeline itself is backend-neutral
  module 2b/c direct fetch or k-of-k' OT per request (host)

Batches group by (backend, n, k'): the stacked crypto needs equal ciphertext
shapes, which (n, k') pins down.  Every lane is bit-identical to the
sequential `protocol.run_remoterag` round — same docs, ids and wire bytes —
so `EngineConfig(sequential=True)` exists purely as the latency/throughput
comparison path.

Failure handling is *lane-level*: a dispatch failure is attributed to the
offending lane(s) — per-lane stages (encryption, retrieval) attribute
directly, batched stages (perturbation, top-k', scoring, decryption) by
bisection over lane subsets — and only those lanes are quarantined: one
solo retry on the sequential path (`EngineConfig.max_retries`), then a
`ServeResult` error result.  Healthy lanes complete from their
already-computed state — they are never re-encrypted, never re-dispatched,
and never double-counted in the metrics.

Over a mesh index (``FlatIndex.build(..., mesh=)``) every rank runs the
same engine, SPMD: the caller opens the same sessions and submits the same
requests in the same order on every rank, and the engine keeps each
collective's issue, order and shapes a function of what the ranks agree
on, never of a rank's clock, thread timing, cache residency or a fault
only it saw:

  * the engine takes process groups of its own (`launch.mesh.fork`) and
    hands them to its search (its `CorpusView`), its cache gathers (its
    cloud) and its agreements, so the replicas of a router, each stepping
    on its own thread, never pair their collectives; the corpus gather and
    the candidate cache (both collective) are built at construction, on
    the caller's thread, and `close` releases the groups;
  * the first rank decides each batch (the group, the request ids in
    order, the ids it sheds) and broadcasts it with the DistanceDP keys of
    the requests whose caller fixed none; the other ranks pop exactly
    those requests.  `drain` goes through the same decision.  With an
    admission tier, `submit` reads the first rank's clock;
  * a session opened without a seed under random seeds takes the first
    rank's seed;
  * every stage's outcome is agreed before bisection, per lane on the
    sequential path and before each collective search, and the search
    agrees on each rank's block scan inside its all-gather: a fault seen
    on every rank gives the one-process quarantine results; a fault seen
    on some ranks only raises `launch.mesh.MeshDivergence` on every rank
    (the tenants' rng streams would otherwise part ways).  A failed
    collective (`launch.mesh.MeshError`, e.g. a rank that died) is fatal
    too: it is never taken for a lane fault, bisected or retried;
  * quarantine retries run inline, in dispatch order (``retry_lane`` is
    not used over a mesh).
"""

from __future__ import annotations

import dataclasses
import itertools
import secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import protocol
from repro_torch.crypto import backend as crypto_backends
from repro_torch.crypto import rlwe
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshDivergence
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import admission as adm
from repro_torch.serve import batching
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.session import Session, SessionManager


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8          # size trigger
    max_wait_s: float = 0.02    # deadline trigger (age of a group's head)
    sequential: bool = False    # comparison path: loop run_remoterag
    # RLWE re-rank candidate cache: True = serve from the index's NTT-domain
    # cache, False = cold per-request packing (bit-identical reference).
    use_candidate_cache: bool = True
    # None = dense device-resident cache; an rlwe.CandidateCacheConfig
    # selects the sharded corpus-scale cache (shard size, device-memory
    # budget for LRU-pinned hot shards, admission policy).
    cache_config: Optional["rlwe.CandidateCacheConfig"] = None
    # solo sequential-path retries per quarantined lane before the request
    # is returned as an error result (0 = fail immediately, never retry)
    max_retries: int = 1
    # continuous refill: a group whose batch dispatched under max_batch
    # (or full but with a burst tail still queued) keeps a one-window
    # credit, so waiting requests join the next dispatch immediately
    # instead of aging out max_wait_s again
    refill: bool = True
    # bounded per-tenant latency/batch-size sample windows (exact totals
    # for counts and wire bytes are kept regardless) — see serve.metrics
    metrics_window: int = 8192
    # stage-level span tracing (repro_torch.obs): off by default — the
    # NULL tracer keeps the disabled cost near zero.  Spans carry only
    # structural facts (redaction enforced at record time, see
    # repro_torch.obs.trace).
    trace: bool = False
    # span ring-buffer capacity; stage histograms stay complete past it
    trace_capacity: int = 65536
    # SLO-aware admission tier (repro_torch.serve.admission): per-tenant token
    # buckets, a bounded global queue with priority displacement, and
    # deadline-aware shedding before any crypto runs.  None (the default)
    # installs no admission machinery at all — submit/step behave
    # bit-identically to the uncontrolled engine.
    admission: Optional["adm.AdmissionConfig"] = None
    # IVF first-stage routing: number of cluster slices each query's
    # top-k' scan probes.  Needs an index built with
    # ``FlatIndex.build(ivf=...)`` (otherwise the flat scan runs and this
    # is ignored).  None = exact flat scan; nprobe >= the cluster count is
    # bit-identical to the flat scan.  Use
    # `repro_torch.retrieval.topk.plan_nprobe` to derive a bound from the
    # Theorem-1 plan's k'.
    nprobe: Optional[int] = None
    # True (default): quarantine solo retries run on a background retry
    # lane (a single worker thread) so a faulty lane's retry wall never
    # costs a healthy batch's p99 — retry results surface from a later
    # step()/drain(), which barriers on retry completion.  False restores
    # the inline retry on the dispatch thread.  Over a mesh index retries
    # always run inline, in dispatch order (their collectives must keep
    # the same order on every rank).
    retry_lane: bool = True


@dataclasses.dataclass
class ServeRequest:
    request_id: int
    tenant: str
    embedding: np.ndarray
    key: int                    # seed of the request's DistanceDP generator
    t_enqueue: float
    group: tuple = ()           # the (backend, n, k') queue key
    retries: int = 0            # solo quarantine retries already spent
    encryptions: int = 0        # query-encryption attempts (waste audit)
    priority: str = "interactive"   # admission.PRIORITIES class
    rank: int = 0                   # cached priority_rank(priority)
    deadline_s: Optional[float] = None  # SLO budget from t_enqueue
    key_drawn: bool = False         # key drawn here (the caller fixed none)


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tenant: str
    docs: List[bytes]
    ids: np.ndarray
    transcript: Optional[protocol.ProtocolTranscript]
    latency_s: float
    batch_size: int
    # None on success; the lane's failure (repr) after its quarantine
    # retries are exhausted.  Failed requests are returned, never dropped.
    error: Optional[str] = None
    # True when this lane was quarantined out of a batched dispatch (the
    # result then came from a solo retry, or is an error result).
    quarantined: bool = False
    # set when the request was shed by the admission tier before any
    # crypto ran (one of admission.SHED_REASONS); `error` is then
    # "shed(<reason>)" so unaware callers still see a non-ok result
    shed_reason: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


# the batched steps whose device ends a traced CUDA dispatch marks, in
# stream order (`ServeEngine._run_batched_stages`)
DEVICE_STEPS = ("perturb", "topk", "encrypt", "score", "decrypt")


def _no_agreement(stage: str, failed: Sequence[bool]) -> None:
    """The agreement hook of an engine over no mesh: nothing to agree."""


def _bisect_lanes(run, lanes: Sequence[int], *,
                  tracer=obs.NULL_TRACER, batch_id: Optional[int] = None,
                  stage: str = "", agree=_no_agreement) -> Tuple[dict, dict]:
    """Fault-attribute one batched stage.  ``run(lane_list)`` computes the
    stage for those lanes and returns one output per lane; the full set is
    tried first (the clean-path fast case — identical work to a monolithic
    dispatch), and a raising subset is split in half until the failure pins
    to single lanes.  Stage functions must be deterministic, per-lane
    independent, and free of tenant-rng side effects — true of the
    perturbation, top-k', scoring and decryption stages, which consume only
    per-request generator seeds, already-encrypted queries, and index
    state — so
    re-running a lane inside a smaller subset reproduces its bits exactly
    and never re-encrypts anything.  ``agree(stage, [failed])`` holds every
    attempt's outcome to the other ranks' (a mesh engine's
    `ServeEngine._agree`).  Returns ({lane: output}, {lane: exception})."""
    out: dict = {}
    bad: dict = {}
    pending = [list(lanes)]
    while pending:
        ls = pending.pop()
        if not ls:
            continue
        try:
            vals, err = run(ls), None
        except mesh_lib.MeshError:
            raise
        except Exception as e:        # noqa: BLE001 — attribution scope
            vals, err = None, e
        agree(stage, [err is not None])
        if err is not None:
            e = err
            tracer.event("bisect", batch_id=batch_id, stage=stage,
                         subset=len(ls), error_type=type(e).__name__)
            if len(ls) == 1:
                bad[ls[0]] = e
            else:
                mid = len(ls) // 2
                pending.append(ls[mid:])
                pending.append(ls[:mid])   # popped first: keep lane order
            continue
        out.update(zip(ls, vals))
    return out, bad


def _lane_stage(fn, lanes: Sequence[int], *, stage: str = "",
                agree=_no_agreement, each: bool = False) -> Tuple[dict, dict]:
    """Per-lane stage with direct attribution: ``fn(lane)`` runs in lane
    order; a raising lane is recorded and its batchmates continue.  The
    lanes' outcomes go through ``agree`` once after the stage, or after
    every lane with ``each`` (a stage whose lanes issue collectives)."""
    out: dict = {}
    bad: dict = {}
    for lane in lanes:
        try:
            out[lane] = fn(lane)
        except mesh_lib.MeshError:
            raise
        except Exception as e:        # noqa: BLE001 — lane-isolated
            bad[lane] = e
        if each:
            agree(stage, [lane in bad])
    if not each:
        agree(stage, [lane in bad for lane in lanes])
    return out, bad


def _plan_of(picked: dict) -> dict:
    """The first rank's `ServeEngine._pick` as the broadcast plan: ids
    only, and the keys this rank drew for the batch's requests."""
    return dict(shed=[(r.request_id, r.shed_reason) for r in picked["shed"]],
                chosen=picked["chosen"],
                rids=[r.request_id for r in picked["batch"]],
                keys={r.request_id: r.key for r in picked["batch"]
                      if r.key_drawn},
                refill=picked["refill"], leftovers=picked["leftovers"])


class ServeEngine:
    """Multi-tenant front end over one RemoteRagCloud, on the index's
    device (sessions default to it; a `SessionManager` on another device
    is refused)."""

    config: EngineConfig
    sessions: SessionManager
    cloud: protocol.RemoteRagCloud
    metrics: ServeMetrics

    def __init__(self, index: FlatIndex, *,
                 config: Optional[EngineConfig] = None,
                 sessions: Optional[SessionManager] = None,
                 clock=time.monotonic,
                 tracer: Optional[obs.Tracer] = None,
                 searcher=None,
                 request_ids: Optional[itertools.count] = None):
        self.config = EngineConfig() if config is None else config
        self.device = index.device
        # `is None` (not truthiness): an empty SessionManager has len 0
        self.sessions = (SessionManager(device=self.device)
                         if sessions is None else sessions)
        if self.sessions.device != self.device:
            raise ValueError(f"sessions on {self.sessions.device}, index on "
                             f"{self.device}")
        # over a mesh index: process groups of this engine's own (see the
        # module docstring), handed to its cloud and its view
        self._mesh = (None if index.mesh is None
                      else mesh_lib.fork(index.mesh, [index.row_axes]))
        self.cloud = protocol.RemoteRagCloud(
            index, rlwe_params=self.sessions.rlwe_params,
            use_candidate_cache=self.config.use_candidate_cache,
            cache_config=self.config.cache_config, mesh=self._mesh)
        # pin the corpus at construction: every default-path search (and
        # the epoch stamp new sessions plan against) reads this frozen
        # snapshot, so a concurrent ingest advancing the index's epoch
        # never changes what this engine serves until `refresh_corpus`
        self.view = index.corpus_view(mesh=self._mesh)
        # an explicit tracer wins (tests inject one built on a fake
        # clock); otherwise EngineConfig.trace selects a real tracer on
        # *the engine's own clock* — queue-wait spans are computed from
        # t_enqueue, so tracer and engine must share one timeline
        if tracer is not None:
            self.tracer = tracer
        elif self.config.trace:
            self.tracer = obs.Tracer(capacity=self.config.trace_capacity,
                                     clock=clock)
        else:
            self.tracer = obs.NULL_TRACER
        self.metrics = ServeMetrics(
            window=self.config.metrics_window,
            tracer=self.tracer if self.tracer.enabled else None)
        self._clock = clock
        # ``request_ids`` lets a fleet share one id counter (the replica
        # router passes its own, so request ids are global submit order,
        # equal to a single engine's); ``searcher`` replaces the top-k'
        # candidate search (the router injects its scatter-gather, see
        # `_search_topk`).  Both default to the standalone engine.
        self._ids = itertools.count() if request_ids is None else request_ids
        self._searcher = searcher
        self._batch_ids = itertools.count()
        # guards _queues/_refill/_shed_results/_retry_*: a router submits
        # from the client thread while each replica steps on its own
        # worker, and the retry lane resolves requests from its own thread
        self._qlock = threading.Lock()
        # per-group priority-classed FIFO queues keyed once at submit:
        # dispatch pops from a group head instead of rescanning/rewriting
        # one global list.  With every request in the default priority
        # class a GroupQueue is exactly the plain FIFO it replaced.
        self._queues: Dict[tuple, adm.GroupQueue] = {}
        # refill credits: group -> grant time of its last partial dispatch
        self._refill: Dict[tuple, float] = {}
        # admission tier (None = uncontrolled engine, zero new machinery)
        self.admission = (
            None if self.config.admission is None
            else adm.AdmissionController(self.config.admission, clock=clock))
        # shed results produced outside step() (queue-bound displacement
        # at submit time) wait here until the next step()/drain() returns
        # them — a displaced request is resolved, never dropped
        self._shed_results: List[ServeResult] = []
        # background quarantine retry lane (EngineConfig.retry_lane): one
        # worker thread, spawned lazily on the first poisoned lane.
        # Finished retries buffer in _retry_results (like _shed_results)
        # until the next step()/drain(); _retry_inflight counts submitted-
        # but-unfinished retries and _retry_cv (on _qlock) lets drain()
        # barrier on them — every request still gets exactly one result.
        self._retry_pool: Optional[ThreadPoolExecutor] = None
        self._retry_results: List[ServeResult] = []
        self._retry_inflight = 0
        self._retry_cv = threading.Condition(self._qlock)
        self._closed = False
        # over a mesh index: the first rank decides, and the collective
        # builds happen here, on this thread
        self._first = True
        self._agreed_seeds: Dict[str, int] = {}
        if index.mesh is not None:
            self._first = mesh_lib.axes_position(
                index.mesh, mesh_lib.row_axes(index.mesh)) == 0
            index.all_rows()
            self.cloud.candidate_cache

    def refresh_corpus(self, epoch: Optional[int] = None):
        """Advance (or pin) this engine's corpus view to ``epoch`` (default:
        the index's current epoch) after an ingest.  Sessions opened
        afterwards plan against, and are stamped with, the refreshed
        corpus; open sessions keep their plans (the corpus only grows, so
        an old plan's Theorem-1 bound stays valid for the rows it was
        planned over).  Call between batches: an engine mid-dispatch keeps
        scanning the view it started with."""
        self.view = self.cloud.index.corpus_view(epoch, mesh=self._mesh)
        return self.view

    # -- session + queue ----------------------------------------------------

    def open_session(self, tenant: str, **session_kwargs) -> Session:
        # plans are stamped with the epoch of the corpus they were planned
        # against (see serve.session.PlanCache); callers may still pin an
        # explicit epoch for replay setups
        session_kwargs.setdefault("epoch", self.view.epoch)
        if (self._mesh is not None and session_kwargs.get("seed") is None
                and not self.sessions.deterministic_seeds):
            # every rank must hold the tenant's keys: the first rank's seed
            seed = self._agreed_seeds.get(tenant)
            if seed is None:
                seed = self._agreed_seeds[tenant] = \
                    mesh_lib.broadcast_object(secrets.randbits(63),
                                              self._mesh)
            session_kwargs["seed"] = seed
        return self.sessions.open(tenant, **session_kwargs)

    def submit(self, tenant: str, embedding: np.ndarray,
               key: Optional[int] = None, *,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one query for `tenant` (session must be open).  Returns a
        request id; results come back from step()/drain().

        ``key`` seeds the request's DistanceDP generator.  The default
        draws OS entropy (``secrets.randbits(63)``) — a predictable key
        (e.g. the request counter) would let the cloud replay the noise
        and strip the perturbation; pass an explicit key only for
        replay/parity setups.

        ``priority`` (one of `admission.PRIORITIES`, default from
        ``AdmissionConfig.default_priority``) and ``deadline_s`` (SLO
        budget from enqueue, default ``AdmissionConfig.default_deadline_s``)
        feed the admission tier.  Rejections are typed
        `admission.AdmissionError` subclasses — `UnknownTenant` (also a
        ``KeyError``), `InvalidEmbedding` (also a ``ValueError``),
        `RateLimited`, `QueueFull` — and a rejected request was never
        enqueued: no crypto ran and no request id was consumed.
        """
        if self._closed:
            raise RuntimeError("engine is closed; no further submissions")
        if tenant not in self.sessions:
            # a real error, not an assert: `python -O` strips asserts and a
            # missing session would then surface as an opaque KeyError deep
            # inside dispatch (or worse, silently mis-batch)
            raise adm.UnknownTenant(tenant)
        emb = np.asarray(embedding, np.float32)
        if emb.ndim != 1:
            # the group key below uses the last axis only, so a (1, n)
            # embedding would batch with (n,) requests and break the
            # batch-stack shapes mid-dispatch; reject it at the door
            raise adm.InvalidEmbedding(
                f"embedding must be 1-D, got shape {emb.shape}")
        ac = self.config.admission
        if priority is None:
            priority = (ac.default_priority if ac is not None
                        else "interactive")
        rank = adm.priority_rank(priority)
        if deadline_s is None and ac is not None:
            deadline_s = ac.default_deadline_s
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        now = self._clock()
        if self._mesh is not None and self.admission is not None:
            # rate limits and displacement read the first rank's clock
            now = mesh_lib.broadcast_object(now, self._mesh)
        with self._qlock:
            if self.admission is not None:
                retry = self.admission.check_rate(tenant, now)
                if retry is not None:
                    self.metrics.record_shed(tenant, adm.SHED_RATE_LIMITED)
                    self.tracer.event("rate_limited", tenant=tenant,
                                      priority=priority)
                    raise adm.RateLimited(tenant, retry)
            bound = ac.max_queue if ac is not None else None
            if bound is not None:
                depth = sum(len(q) for q in self._queues.values())
                # displace the youngest request of the worst strictly
                # lower-priority class (it becomes a queue_full shed
                # result, returned by the next step/drain), else reject
                # the newcomer — counted drops either way, never silent
                if depth >= bound and not self._displace(rank, now):
                    self.metrics.record_shed(tenant, adm.SHED_QUEUE_FULL)
                    self.tracer.event("shed", reason=adm.SHED_QUEUE_FULL,
                                      tenant=tenant, priority=priority)
                    raise adm.QueueFull(tenant, depth, bound)
            if self.admission is not None:
                self.metrics.record_admitted(tenant)
            rid = next(self._ids)
            drawn = key is None
            if drawn:
                key = secrets.randbits(63)
            sess = self.sessions.get(tenant)
            group = (sess.backend, emb.shape[-1], sess.plan.kprime)
            self._queues.setdefault(group, adm.GroupQueue()).append(
                ServeRequest(
                    request_id=rid, tenant=tenant, embedding=emb, key=key,
                    t_enqueue=now, group=group,
                    priority=priority, rank=rank, deadline_s=deadline_s,
                    key_drawn=drawn))
        return rid

    def _displace(self, rank: int, now: float) -> bool:
        """Evict one queued request of a class strictly worse than `rank`
        to make room: the youngest request of the worst class present,
        resolved as a ``queue_full`` shed result.  False if every queued
        request is at least as good as the newcomer."""
        victim = None
        victim_key = None
        victim_rank = -1
        for key, q in self._queues.items():
            w = q.worst()
            if w is None:
                continue
            r, req = w
            if r <= rank:
                continue
            if (victim is None or r > victim_rank
                    or (r == victim_rank
                        and req.t_enqueue > victim.t_enqueue)):
                victim, victim_key, victim_rank = req, key, r
        if victim is None:
            return False
        q = self._queues[victim_key]
        q.remove(victim)
        if not q:
            del self._queues[victim_key]
            # an emptied group's refill credit dies with it — a credit
            # with no continuity to real queued work must never dispatch
            self._refill.pop(victim_key, None)
        self._shed_results.append(
            self._resolve_shed(victim, adm.SHED_QUEUE_FULL, now))
        return True

    def _resolve_shed(self, req: ServeRequest, reason: str,
                      now: float) -> ServeResult:
        """Turn a queued request into a typed shed result: counted in the
        metrics, surfaced as a trace event, never run through any crypto
        stage, and never recorded as dispatch/latency traffic."""
        self.metrics.record_shed(req.tenant, reason)
        self.tracer.event("shed", track=f"request-{req.request_id}",
                          request_id=req.request_id, tenant=req.tenant,
                          priority=req.priority, reason=reason)
        return ServeResult(
            request_id=req.request_id, tenant=req.tenant, docs=[],
            ids=np.empty(0, np.int64), transcript=None,
            latency_s=now - req.t_enqueue, batch_size=0,
            error=f"shed({reason})", shed_reason=reason)

    @property
    def pending(self) -> int:
        with self._qlock:
            return sum(len(q) for q in self._queues.values())

    def cache_stats(self) -> Optional[dict]:
        """LRU / gather counters of the sharded candidate cache (None for
        the dense cache, cold packing, or before the lazy build — this
        never triggers the build itself)."""
        cache = self.cloud.index.peek_candidate_cache(
            self.cloud.rlwe_params, self.cloud.cache_config)
        if isinstance(cache, rlwe.ShardedCandidateCache):
            return cache.stats()
        return None

    # -- telemetry ----------------------------------------------------------

    def trace_summary(self) -> Optional[dict]:
        """JSON-ready stage-level telemetry snapshot (span counts + per-
        stage histograms); None when tracing is disabled.  The same
        snapshot rides along in ``metrics.summary()["trace"]``."""
        return self.tracer.snapshot() if self.tracer.enabled else None

    def write_trace(self, path: str) -> int:
        """Write the span ring as a Chrome-trace (Perfetto-loadable) JSON
        timeline; returns the number of duration events written."""
        if not self.tracer.enabled:
            raise RuntimeError(
                "tracing is disabled; construct the engine with "
                "EngineConfig(trace=True) or pass tracer=")
        return obs.write_chrome_trace(
            path, self.tracer.spans(),
            stage_summary=self.tracer.stage_summary())

    # -- lifecycle ----------------------------------------------------------

    def close(self, *, shed_pending: bool = False) -> List[ServeResult]:
        """Drain the queues, then release engine-held background resources:
        the sharded candidate cache's admitter thread is stopped (pending
        admissions still complete; the index-memoized cache itself stays
        valid and restarts its worker lazily if another engine touches it).
        Idempotent; returns the final drain's results.  `submit` raises
        after close.  Over a mesh index every rank closes in lockstep, and
        the engine's process groups (`launch.mesh.release`) go with it.

        ``shed_pending=True`` resolves still-queued requests as
        ``shutdown`` shed results instead of dispatching them (see
        `drain`) — the load-shedding shutdown for an engine going away
        under pressure."""
        if self._closed:
            return []
        out = self.drain(shed=shed_pending)
        self._closed = True
        if self._retry_pool is not None:   # idle after the drain barrier
            self._retry_pool.shutdown(wait=True)
            self._retry_pool = None
        cache = self.cloud.index.peek_candidate_cache(
            self.cloud.rlwe_params, self.cloud.cache_config)
        if isinstance(cache, rlwe.ShardedCandidateCache):
            cache.close()
        if self._mesh is not None:          # every rank closes in lockstep
            mesh_lib.release(self._mesh)
        return out

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    # -- dispatch -----------------------------------------------------------

    def step(self, *, force: bool = False) -> List[ServeResult]:
        """Dispatch at most one batch if a trigger fired (or `force`).

        Among triggered groups the best-priority head wins, oldest first
        within a class — a group that keeps hitting the size trigger must
        not starve another group whose deadline expired, and under
        overload interactive heads pre-empt best-effort ones.  A group
        holding a *refill credit* (its previous batch dispatched under
        `max_batch` within the last `max_wait_s`) triggers immediately:
        continuous batching keeps occupancy up without making late
        arrivals age out a fresh deadline.

        With the admission tier enabled the step starts by resolving any
        pending shed work: queue-bound displacements buffered at submit
        time, then a deadline pass that sheds every queued request whose
        remaining budget is spent or below the group's observed p50
        dispatch latency — all *before* a batch is popped, so shed
        requests never reach any crypto stage.

        Over a mesh index the first rank makes this choice and broadcasts
        it (see the module docstring); every rank then dispatches the same
        batch."""
        return self._step(force)

    def _step(self, force: bool) -> List[ServeResult]:
        now = self._clock()
        cfg = self.config
        # trigger selection and the batch pop happen under the queue lock
        # (the retry lane resolves requests from its own thread); the
        # dispatch itself — all the crypto — runs outside it
        with self._qlock:
            shed: List[ServeResult] = []
            if self._shed_results:
                shed, self._shed_results = self._shed_results, []
            if self._retry_results:     # finished background retries
                shed.extend(self._retry_results)
                self._retry_results = []
            picked = self._pick(now, force) if self._first else None
        if self._mesh is not None:
            plan = mesh_lib.broadcast_object(
                _plan_of(picked) if self._first else None, self._mesh)
            if not self._first:
                with self._qlock:
                    picked = self._apply_plan(plan, now)
        shed.extend(picked["shed"])
        chosen = picked["chosen"]
        if chosen is None:
            return shed
        batch, chosen_refill = picked["batch"], picked["refill"]
        leftovers = picked["leftovers"]
        t_dispatch = self._clock()
        out = self._dispatch(batch)
        if self.admission is not None:
            # feed the per-group dispatch-latency histogram the deadline
            # shedding reads (p50, biased high by at most one log2 bucket)
            self.admission.observe_dispatch(
                chosen, self._clock() - t_dispatch)
        if chosen_refill and any(r.ok for r in out):
            # recorded post-dispatch like record_batch: an all-lanes
            # failure must not read as refill-served traffic
            self.metrics.record_refill(len(batch))
            self.tracer.event("refill", requests=len(batch))
        # only a deadline/size-triggered dispatch grants a credit — for a
        # partial batch (spare lanes for late arrivals) or a full one that
        # left a burst tail queued.  A refill dispatch must not re-grant
        # (the credit would self-renew and a group under steady light
        # traffic would never form a real batch again; a refill dispatch
        # with a leftover tail is impossible — the size trigger wins
        # there), and drain()'s forced flushes leave no credit behind.
        # Stamped *after* the dispatch returns: the crypto takes far
        # longer than a batching window, so a pre-dispatch stamp would
        # always be expired by the time the caller can step() again.
        if (cfg.refill and not chosen_refill and not force
                and (len(batch) < cfg.max_batch or leftovers)):
            with self._qlock:
                self._refill[chosen] = self._clock()
        return shed + out

    def _pick(self, now: float, force: bool) -> dict:
        """The step's choice, made under the queue lock: the deadline pass's
        shed results, then the triggered group (None if no trigger fired)
        and its batch, popped.  Keys: ``shed``, ``chosen``, ``batch``,
        ``refill`` (a refill credit fired it) and ``leftovers`` (a burst
        tail stays queued)."""
        cfg = self.config
        shed: List[ServeResult] = []
        if self.admission is not None and cfg.admission.shed_deadlines:
            shed.extend(self._shed_expired(now))
        if self._refill:           # credits live one batching window
            self._refill = {g: t for g, t in self._refill.items()
                            if now - t < cfg.max_wait_s}
        chosen = None
        chosen_key = None
        chosen_refill = False
        for key, group in self._queues.items():
            size_hit = len(group) >= cfg.max_batch
            head_t = group.oldest_enqueue()
            deadline_hit = (now - head_t) >= cfg.max_wait_s
            refill_hit = cfg.refill and key in self._refill
            if not (size_hit or deadline_hit or refill_hit or force):
                continue
            # (head class rank, oldest enqueue): with every request in
            # the default class this is exactly the oldest-head-wins
            # order of the uncontrolled engine
            cand_key = (group.head_rank(), head_t)
            if chosen is None or cand_key < chosen_key:
                chosen = key
                chosen_key = cand_key
                chosen_refill = refill_hit and not (
                    size_hit or deadline_hit or force)
        picked = dict(shed=shed, chosen=chosen, batch=[], refill=False,
                      leftovers=False)
        if chosen is None:
            return picked
        group = self._queues[chosen]
        picked["batch"] = group.pop_batch(cfg.max_batch)
        if not group:
            del self._queues[chosen]
        self._refill.pop(chosen, None)       # credit consumed
        picked["refill"] = chosen_refill
        picked["leftovers"] = chosen in self._queues  # burst tail queued
        return picked

    def _apply_plan(self, plan: dict, now: float) -> dict:
        """A mesh rank other than the first: shed and pop exactly the
        requests of the first rank's `_plan_of` (under the queue lock), and
        take its DistanceDP keys where no caller fixed them."""
        queued = {req.request_id: (key, req)
                  for key, q in self._queues.items() for req in q}

        def take(rid: int):
            got = queued.pop(rid, None)
            if got is None:
                raise MeshDivergence(
                    f"request {rid} is not queued on this rank: the ranks' "
                    f"submissions differ")
            key, req = got
            q = self._queues[key]
            q.remove(req)
            if not q:
                del self._queues[key]
                self._refill.pop(key, None)
            return req

        shed = [self._resolve_shed(take(rid), reason, now)
                for rid, reason in plan["shed"]]
        batch = [take(rid) for rid in plan["rids"]]
        for req in batch:
            if req.request_id in plan["keys"]:
                req.key = plan["keys"][req.request_id]
        if plan["chosen"] is not None:
            self._refill.pop(plan["chosen"], None)
        return dict(shed=shed, chosen=plan["chosen"], batch=batch,
                    refill=plan["refill"], leftovers=plan["leftovers"])

    def _agree(self, stage: str, failed: Sequence[bool]) -> None:
        """Over a mesh index: hold this rank's outcome of a stage (which
        lanes failed) to every other rank's; raises `MeshDivergence` on
        every rank when they differ or the ranks are at different stages.
        Nothing over no mesh."""
        if self._mesh is None:
            return
        mine = (stage, tuple(bool(f) for f in failed))
        every = mesh_lib.gather_objects(mine, self._mesh)
        if any(o != mine for o in every):
            raise MeshDivergence(f"stage outcomes differ across ranks: "
                                 f"{every}")

    def _shed_expired(self, now: float) -> List[ServeResult]:
        """Deadline pass over every queue: resolve each request the
        controller deems unservable (budget expired, or remaining budget
        below the group's observed p50 dispatch wall) as a ``deadline``
        shed result.  A group emptied by shedding is removed *with its
        refill credit* — a leftover credit would otherwise let the next
        stray submit dispatch instantly as a phantom refill batch."""
        ctl = self.admission
        out: List[ServeResult] = []
        for key, q in list(self._queues.items()):
            expired = q.shed(lambda req: ctl.should_shed(req, now))
            for req in expired:
                out.append(self._resolve_shed(req, adm.SHED_DEADLINE, now))
            if not q:
                del self._queues[key]
                self._refill.pop(key, None)
        return out

    def drain(self, *, shed: bool = False) -> List[ServeResult]:
        """Flush the queue completely; results in request order.

        ``shed=False`` (default) dispatches everything batch by batch —
        the historical behavior.  ``shed=True`` resolves still-queued
        requests as ``shutdown`` shed results instead: an engine shutting
        down under load answers every queued request immediately and
        spends no further crypto on work nobody is waiting for.  Either
        way every submitted request gets exactly one result — buffered
        displacement sheds are flushed here too, even when the queues are
        already empty."""
        return self._drain(shed)

    def _drain(self, shed: bool) -> List[ServeResult]:
        out: List[ServeResult] = []
        with self._qlock:
            if self._shed_results:
                out, self._shed_results = self._shed_results, []
            if shed:
                now = self._clock()
                for key, q in list(self._queues.items()):
                    for req in q:
                        out.append(
                            self._resolve_shed(req, adm.SHED_SHUTDOWN, now))
                self._queues.clear()
                self._refill.clear()
        while self.pending:
            out.extend(self._step(True))
        # retry-lane barrier: poisoned lanes handed to the background
        # retry lane during the flush above (or by earlier steps) must
        # resolve before drain returns — every submit gets one result
        with self._retry_cv:
            while self._retry_inflight:
                self._retry_cv.wait()
            if self._retry_results:
                out.extend(self._retry_results)
                self._retry_results = []
        return sorted(out, key=lambda r: r.request_id)

    def _dispatch(self, batch: Sequence[ServeRequest]) -> List[ServeResult]:
        """Run one batch through the protocol; never lose a request.

        Both paths attribute failures per lane: the sequential path is a
        lane loop, the batched path isolates inside `_run_batched`.  The
        batch is recorded in the metrics only if at least one lane
        completed in the dispatch — an all-lanes failure is a failed
        dispatch, and solo quarantine retries are never recorded as
        batches of their own (no phantom or duplicate batches)."""
        if not batch:           # defensive: shedding never pops, but an
            return []           # empty dispatch must stay a no-op
        poisoned: List[tuple] = []          # (request, its exception)
        bid = next(self._batch_ids)
        tr = self.tracer
        if tr.enabled:
            # queue wait is the interval the tenant already spent before
            # any stage ran: t_enqueue -> dispatch start, on the engine's
            # own clock (same one t_enqueue was stamped with)
            now = self._clock()
            for req in batch:
                tr.record("queue_wait", req.t_enqueue, now,
                          track=f"request-{req.request_id}",
                          request_id=req.request_id, batch_id=bid,
                          tenant=req.tenant)
        with tr.span("dispatch", batch_id=bid, batch_size=len(batch),
                     backend=batch[0].group[0]):
            if self.config.sequential:
                results, bad = _lane_stage(
                    lambda lane: self._run_one(batch[lane]),
                    range(len(batch)), stage="sequential",
                    agree=self._agree, each=True)
                poisoned = [(batch[lane], err)
                            for lane, err in bad.items()]
                results = [results[lane] for lane in sorted(results)]
            else:
                results, poisoned = self._run_batched(batch, bid)
        if results:
            # size = the dispatch slot, completed = the lanes that actually
            # finished in it — occupancy() reads the latter, so quarantined
            # lanes show up as lost occupancy instead of hiding behind a
            # full-looking batch
            self.metrics.record_batch(len(batch), completed=len(results))
        elif poisoned:
            self.metrics.record_dispatch_failure(len(batch))
        by_id = {r.request_id: r for r in batch}
        for res in results:
            self.metrics.record(res.tenant, latency_s=res.latency_s,
                                batch_size=res.batch_size,
                                transcript=res.transcript,
                                deadline_s=by_id[res.request_id].deadline_s)
            extra = by_id[res.request_id].encryptions - 1
            if extra > 0:       # contract: healthy lanes encrypt once
                self.metrics.record_healthy_reencryptions(extra)
        if poisoned:
            results = results + self._quarantine(poisoned, len(batch))
        return results

    def _quarantine(self, poisoned: Sequence[tuple],
                    batch_size: int) -> List[ServeResult]:
        """Quarantine tail of `_dispatch` (``poisoned`` is (request,
        exception) pairs — each lane carries *its own* attributed failure):
        every poisoned lane is isolated from its batchmates and retried
        solo on the sequential path (`EngineConfig.max_retries` attempts,
        latency still measured from the original submit), then returned as
        an error result.  Healthy lanes are untouched — no re-encryption,
        no re-dispatch, no double-counted metrics.

        With `EngineConfig.retry_lane` (the default) the solo retries are
        handed to the background retry lane instead of running here on the
        dispatch thread — this call then returns nothing and the lane's
        result surfaces from a later step()/drain() (which barriers on
        retry completion), so a faulty lane's retry wall stops costing its
        next healthy batch's p99."""
        out: List[ServeResult] = []
        self.metrics.record_quarantined(len(poisoned))
        tr = self.tracer
        for req, err in poisoned:
            tr.event("quarantine", track=f"request-{req.request_id}",
                     request_id=req.request_id, tenant=req.tenant,
                     error_type=type(err).__name__)
            if self.config.retry_lane and self._mesh is None:
                self._retry_submit(req, err, batch_size)
            else:
                out.append(self._retry_solo(req, err, batch_size))
        return out

    def _retry_solo(self, req: ServeRequest, err: Exception,
                    batch_size: int) -> ServeResult:
        """One quarantined lane's solo retries: sequential-path attempts
        until one completes or `max_retries` is spent, then an error
        result.  Runs on the dispatch thread (retry_lane=False) or the
        retry-lane worker — the metrics are internally locked and the
        sequential path takes the tenant's session lock, so both homes are
        safe."""
        tr = self.tracer
        res = None
        while req.retries < self.config.max_retries:
            req.retries += 1
            self.metrics.record_retries(1)
            try:
                with tr.span("retry", track=f"request-{req.request_id}",
                             request_id=req.request_id,
                             tenant=req.tenant, attempt=req.retries):
                    res = self._run_one(req)
            except mesh_lib.MeshError:
                raise
            except Exception as e:  # noqa: BLE001 — retry keeps its err
                err, res = e, None
            self._agree("retry", [res is None])
            if res is None:
                continue
            res.quarantined = True
            self.metrics.record_quarantined_retry_ok(req.tenant)
            # recorded exactly once, here (the failed batched attempt
            # recorded nothing for this lane)
            self.metrics.record(req.tenant, latency_s=res.latency_s,
                                batch_size=res.batch_size,
                                transcript=res.transcript,
                                deadline_s=req.deadline_s)
            break
        if res is None:
            self.metrics.record_error(req.tenant)
            res = ServeResult(
                request_id=req.request_id, tenant=req.tenant, docs=[],
                ids=np.empty(0, np.int64), transcript=None,
                latency_s=self._clock() - req.t_enqueue,
                batch_size=batch_size, error=repr(err), quarantined=True)
        return res

    def _retry_submit(self, req: ServeRequest, err: Exception,
                      batch_size: int) -> None:
        """Hand one poisoned lane to the background retry lane (spawned
        lazily here — an engine that never quarantines never starts the
        thread).  The inflight count is raised *before* the submit so a
        drain() racing this dispatch already sees the retry coming."""
        with self._qlock:
            if self._retry_pool is None:
                self._retry_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="retry-lane")
            self._retry_inflight += 1
        self._retry_pool.submit(self._retry_worker, req, err, batch_size)

    def _retry_worker(self, req: ServeRequest, err: Exception,
                      batch_size: int) -> None:
        try:
            res = self._retry_solo(req, err, batch_size)
        except BaseException as e:  # noqa: BLE001 — zero-loss contract
            # _retry_solo resolves protocol failures itself; this only
            # fires on harness-level faults, and the request still gets
            # exactly one (error) result
            res = ServeResult(
                request_id=req.request_id, tenant=req.tenant, docs=[],
                ids=np.empty(0, np.int64), transcript=None,
                latency_s=self._clock() - req.t_enqueue,
                batch_size=batch_size, error=repr(e), quarantined=True)
        with self._retry_cv:
            self._retry_results.append(res)
            self._retry_inflight -= 1
            self._retry_cv.notify_all()

    def _generator(self, key: int) -> torch.Generator:
        """A fresh DistanceDP generator for one request on the engine's
        device: re-created from the request's seed on every attempt, so a
        bisected re-run or a solo retry reproduces the lane's noise."""
        return torch.Generator(device=self.device).manual_seed(int(key))

    def _search_topk(self, perturbed, kprime: int, *,
                     tracer=obs.NULL_TRACER) -> np.ndarray:
        """Module 2a, cloud half: the (B, k') host candidate-id block for a
        (B, n) block of perturbed embeddings.  The default scans the
        engine's pinned `CorpusView` (through the IVF first stage when
        `EngineConfig.nprobe` is set on a clustered corpus); a router
        injects a scatter-gather searcher (``searcher=``) that fans the
        block out to every replica's slice and merges, by contract bit for
        bit the full scan.  Must stay a pure function of (perturbed,
        kprime): `_bisect_lanes` re-runs arbitrary row subsets through it
        for fault attribution.  ``tracer`` reaches the flat scan's
        certificate span; an injected searcher gets none."""
        if self._searcher is not None:
            return np.asarray(self._searcher(perturbed, kprime))
        # a collective search: every rank must get here (see _agree)
        self._agree("search", [False])
        try:
            return batching.topk_batch(
                self.view, perturbed, kprime, nprobe=self.config.nprobe,
                tracer=tracer).indices.cpu().numpy()
        except MeshDivergence:
            # the search's row group parted ways: tell the ranks of the
            # other row groups, which raise at their next agreement
            mesh_lib.gather_objects(("search", None), self._mesh)
            raise

    # -- sequential comparison path ----------------------------------------

    def _run_one(self, req: ServeRequest) -> ServeResult:
        sess = self.sessions.get(req.tenant)
        req.encryptions += 1
        self.metrics.record_encryptions(1)
        with self.tracer.span("sequential",
                              track=f"request-{req.request_id}",
                              request_id=req.request_id,
                              tenant=req.tenant):
            # top-k' goes through this engine's searcher, not a whole-index
            # scan: under a router that is the per-slice scan + merge, so a
            # quarantined lane's solo retry stays bit-identical to the
            # scatter-gather path by construction.  The session lock keeps
            # the tenant's rng stream serialized against a concurrent
            # dispatch batch when this runs on the retry lane.
            with sess.lock:
                docs, ids, tr = protocol.run_remoterag(
                    sess.user, self.cloud, req.embedding,
                    self._generator(req.key), topk_fn=self._search_topk)
                sess.num_requests += 1
        return ServeResult(request_id=req.request_id, tenant=req.tenant,
                           docs=docs, ids=ids, transcript=tr,
                           latency_s=self._clock() - req.t_enqueue,
                           batch_size=1)

    # -- batched protocol path ---------------------------------------------

    def _run_batched(self, batch: Sequence[ServeRequest],
                     bid: Optional[int] = None) -> tuple:
        """One batch through the staged batched protocol with lane-level
        fault isolation.  Returns ``(results, poisoned)`` where ``results``
        are the lanes that completed (in lane order) and ``poisoned`` is
        ``[(request, exception)]`` for the lanes a failure was attributed
        to.  A failure *outside* the attributable stages (batch assembly,
        the lazy candidate-cache build, prefetch) cannot be pinned to a
        lane, so the whole batch is returned as poisoned — every request
        still gets its quarantine retry and error accounting; nothing is
        ever lost to a propagating exception."""
        try:
            return self._run_batched_stages(batch, bid)
        except mesh_lib.MeshError:
            raise
        except Exception as e:          # noqa: BLE001 — zero-loss contract
            return [], [(req, e) for req in batch]

    def _run_batched_stages(self, batch: Sequence[ServeRequest],
                            bid: Optional[int] = None) -> tuple:
        """Stage pipeline behind `_run_batched`.  Batched stages attribute
        failures by bisection (`_bisect_lanes`); naturally per-lane stages
        attribute directly (`_lane_stage`).  Surviving lanes are re-batched
        (compacted) after every stage and carry their already-computed
        state forward — a healthy lane's query is encrypted exactly once,
        whatever its batchmates do.

        Traced, the stages hand a binding of the tracer (``btr``) down to
        their sub-spans; on CUDA it also marks the device end of each
        batched step (decryption's inside `rlwe.decrypt_scores_batch`,
        which anchors the marks after the scores' copy), and a dispatch
        that kept every lane records them as ``<stage>_device`` spans at
        its end."""
        sessions = [self.sessions.get(r.tenant) for r in batch]
        users = [s.user for s in sessions]
        backend = users[0].backend
        impl = crypto_backends.get_backend(backend)
        kprime = users[0].plan.kprime
        params = self.sessions.rlwe_params
        tr = self.tracer
        btr = tr.bind(batch_id=bid, device=self.device)
        btr.mark_device("start", self.device)

        poisoned: List[tuple] = []
        alive = list(range(len(batch)))

        def drop(bad: dict) -> None:
            nonlocal alive
            if bad:
                for lane in sorted(bad):
                    poisoned.append((batch[lane], bad[lane]))
                alive = [lane for lane in alive if lane not in bad]

        # module 1: batched DistanceDP over per-request generators /
        # per-tenant eps.  Lane b == perturb(generator(keys[b]), E[b],
        # eps[b]) with a fresh generator per run, so a bisected re-run of
        # any lane subset is bit-identical.
        E = np.stack([r.embedding for r in batch])
        with tr.span("perturb", batch_id=bid, lanes=len(alive)):
            pert, bad = _bisect_lanes(
                lambda ls: list(batching.perturb_batch(
                    [self._generator(batch[lane].key) for lane in ls],
                    E[list(ls)], [users[lane].plan.eps for lane in ls],
                    device=self.device)),
                alive, tracer=tr, batch_id=bid, stage="perturb",
                agree=self._agree)
            btr.mark_device("perturb", self.device)
        drop(bad)
        if not alive:
            return [], poisoned

        # module 2a, cloud half first: one top-k' kernel call for all
        # surviving lanes.  Running it before the encryption surfaces the
        # candidate ids early so sharded-cache shard admissions can be
        # prefetched — the admitter's copy then overlaps the RLWE encrypt
        # work below.  Bit-identity is unaffected:
        # top-k' consumes only the perturbed embeddings, never the tenants'
        # rng streams (which also makes its bisected re-runs exact).
        with tr.span("topk", batch_id=bid, lanes=len(alive),
                     kprime=kprime):
            cand, bad = _bisect_lanes(
                lambda ls: list(self._search_topk(
                    torch.stack([pert[lane] for lane in ls]), kprime,
                    tracer=btr)),
                alive, tracer=tr, batch_id=bid, stage="topk",
                agree=self._agree)
            btr.mark_device("topk", self.device)
        drop(bad)
        if not alive:
            return [], poisoned
        cache = impl.cache_view(self.cloud)
        if isinstance(cache, rlwe.ShardedCandidateCache):
            # stamp the trace context every dispatch: the cache is index-
            # memoized and may be shared across engines, so each dispatch
            # (re)binds its own tracer, and admissions this batch enqueues
            # are parented to it even when the admitter thread completes
            # them later
            cache.set_trace_context(tr, bid)
            try:
                cache.prefetch(np.stack([cand[lane] for lane in alive]))
            except Exception:   # noqa: BLE001 — prefetch is best-effort
                # a pure admission hint: gather streams from the host pool
                # without it, so a prefetch fault must not poison a batch
                # whose crypto path is fine
                pass

        # module 2a, user half: encrypt queries (submission order so
        # each tenant's rng stream matches the sequential path).  Naturally
        # per-lane — a raising lane is attributed directly, and healthy
        # lanes keep their ciphertexts (they are never encrypted again).
        def encrypt(lane: int):
            req = batch[lane]
            req.encryptions += 1
            self.metrics.record_encryptions(1)
            with tr.span("encrypt", track=f"request-{req.request_id}",
                         request_id=req.request_id, batch_id=bid,
                         tenant=req.tenant, lane=lane):
                with sessions[lane].lock:   # rng draw vs. the retry lane
                    return users[lane].encrypt_query(
                        req.embedding, tracer=btr.bind(
                            track=f"request-{req.request_id}",
                            request_id=req.request_id, lane=lane))

        enc, bad = _lane_stage(encrypt, alive, stage="encrypt",
                               agree=self._agree)
        btr.mark_device("encrypt", self.device)
        drop(bad)
        if not alive:
            return [], poisoned
        wire = {lane: protocol.Request(perturbed=pert[lane], kprime=kprime,
                                       enc_query=enc[lane], backend=backend)
                for lane in alive}

        # module 2a, cloud half continued: one batched encrypted re-rank
        # over the surviving lanes, through the crypto-backend seam (the
        # RLWE impl hits the index's NTT-domain candidate cache).
        # The stage is a pure function of the already-encrypted queries,
        # so bisection re-runs scoring, never encryption.  The clean path
        # keeps the whole-batch score object alive so decryption can take
        # the stacked fast path (no per-lane restack); per-lane views are
        # still handed out for the wire Reply objects and for bisected
        # fallbacks.
        full_stack: List[object] = []

        def score(ls):
            stack = impl.score_candidates(
                cloud=self.cloud, users=[users[lane] for lane in ls],
                enc=[enc[lane] for lane in ls],
                cand_ids=np.stack([cand[lane] for lane in ls]),
                kprime=kprime, params=params, cache=cache)
            if len(ls) == len(alive):     # full-set call succeeded
                full_stack.append(stack)
            return stack.lanes()

        with tr.span("score", batch_id=bid, lanes=len(alive),
                     kprime=kprime, backend=backend):
            cts, bad = _bisect_lanes(score, alive, tracer=tr,
                                     batch_id=bid, stage="score",
                                     agree=self._agree)
            btr.mark_device("score", self.device)
        if bad:
            full_stack.clear()            # stack no longer matches alive
        drop(bad)
        if not alive:
            return [], poisoned

        # back on the users: batched decryption (per-tenant keys) + sort —
        # again pure in the ciphertexts, so bisection is re-decryption only
        def decrypt(ls):
            stacked = (full_stack[0]
                       if full_stack and len(ls) == len(alive)
                       else [cts[lane] for lane in ls])
            return impl.decrypt_scores([users[lane].sk for lane in ls],
                                       stacked, device=self.device,
                                       tracer=btr)

        with tr.span("decrypt", batch_id=bid, lanes=len(alive)):
            scores, bad = _bisect_lanes(decrypt, alive, tracer=tr,
                                        batch_id=bid, stage="decrypt",
                                        agree=self._agree)
        drop(bad)

        # module 2b/2c + accounting, per lane (direct attribution)
        def finish(lane: int) -> ServeResult:
            user = users[lane]
            req = batch[lane]
            reply = protocol.Reply(candidate_ids=cand[lane],
                                   enc_scores=cts[lane])
            with tr.span("finish", track=f"request-{req.request_id}",
                         request_id=req.request_id, batch_id=bid,
                         tenant=req.tenant, lane=lane):
                with sessions[lane].lock:   # OT draws rng, see Session.lock
                    positions = user.positions_from_scores(
                        scores[lane], len(reply.candidate_ids))
                    docs, ids, transcript = protocol.finish_request(
                        user, self.cloud, wire[lane], reply, positions)
                    sessions[lane].num_requests += 1
            return ServeResult(
                request_id=req.request_id,
                tenant=req.tenant, docs=docs, ids=ids,
                transcript=transcript,
                latency_s=self._clock() - req.t_enqueue,
                batch_size=len(batch))

        done, bad = _lane_stage(finish, alive, stage="finish",
                                agree=self._agree)
        drop(bad)
        if not poisoned:
            btr.record_device_spans(DEVICE_STEPS, lanes=len(alive))
        return [done[lane] for lane in alive], poisoned


__all__ = ["EngineConfig", "ServeRequest", "ServeResult", "ServeEngine",
           "MeshDivergence", "DEVICE_STEPS"]
