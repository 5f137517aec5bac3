"""Span-based request tracing with a redact-by-construction schema.

The serving path is a privacy boundary: the paper's threat model is an
honest-but-curious cloud reconstructing queries from embeddings, so the
telemetry must never become the side channel the protocol closes.  Spans
therefore carry *only* structural facts — stage names, durations, lane
counts, shard ids, tenant ids, byte counts — and the schema enforces that
at record time: every attribute key must be on `ALLOWED_ATTR_KEYS` and
every value must be a short scalar.  Embeddings, plaintexts, scores, doc
ids, or any array/bytes payload are rejected with an exception, not
logged.  Exceptions are recorded as ``type(e).__name__`` only (a repr
could embed query-derived payloads).

`Tracer` is thread-safe (the sharded cache's background admitter records
into the same ring as the engine thread) and bounded: spans live in a
fixed-capacity ring buffer (oldest dropped first, `dropped` counts them)
while per-stage `StageHistogram` aggregates are updated on every span, so
the stage-level p50/p99 profile stays complete even after the ring wraps.

Tracing is off by default — `NULL_TRACER` is a shared no-op sink whose
`span()` returns a reusable empty context manager, keeping the disabled
cost to a dict build and an attribute lookup per call site.

While enabled, every span also opens a ``torch.profiler.record_function``
range named ``repro_torch/<span name>``, so a profiler trace of the
engine carries the program's spans beside the kernels, on the profiler's
own clock.  `Tracer.bind` hands a tracer down to the code that records
sub-spans (decryption's wait, copy and CRT, encryption's draws, the
first stage's certificate) with the caller's span keywords fixed; a
binding made with a CUDA ``device`` also keeps the timing events that
end a dispatch's device steps and turns them into ``<stage>_device``
spans on the ``device`` track, on the tracer's clock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.obs.histogram import StageHistogram, summarize

# The full vocabulary of span attribute keys.  Everything here is
# structural (sizes, ids of *public* objects like shards and tenants,
# counters, stage/error names) — never query-derived content.  Adding a
# key is a reviewed schema change, not a call-site convenience.
ALLOWED_ATTR_KEYS = frozenset({
    "attempt",        # solo-retry attempt number
    "backend",        # "rlwe" | "paillier"
    "batch_size",     # lanes in the dispatch slot
    "bytes",          # byte *count* (never byte contents)
    "capacity",       # ring/queue capacity
    "count",          # generic item count
    "error_type",     # exception class name only
    "hits",           # cache hits (count)
    "kprime",         # candidate count k' (public plan knob)
    "lane",           # lane index within a batch
    "lanes",          # number of lanes in a batched stage
    "misses",         # cache misses (count)
    "n_dim",          # embedding dimensionality (public shape)
    "num_cands",      # candidate rows touched (count)
    "num_shards",     # shards in the cache pool
    "ok",             # success flag
    "priority",       # admission priority class name (public knob)
    "queue",          # queue depth (count)
    "reason",         # short machine-chosen label (e.g. shed reason)
    "replica",        # replica id (public placement index, router tier)
    "replicas",       # replicas touched (count, scatter fan-out)
    "requests",       # request count
    "resident",       # device-resident shard count
    "shard",          # shard id (public partition index, not a doc id)
    "shards",         # shards touched (count)
    "stage",          # stage name a meta-event refers to
    "subset",         # bisection subset size
    "tenant",         # tenant id (public session identity)
})

_MAX_STR = 64        # short labels only; doc text cannot fit a label


def validate_attrs(attrs: dict) -> dict:
    """Return a sanitized copy of ``attrs`` or raise.

    Enforces the redaction contract: whitelisted keys, scalar values
    (bool/int/float/str and their numpy scalar equivalents), strings at
    most ``_MAX_STR`` chars.  Arrays, bytes, lists, dicts — anything that
    could smuggle an embedding, plaintext, score vector or doc-id list —
    raise ``ValueError``/``TypeError`` at the record site.
    """
    out = {}
    for key, val in attrs.items():
        if key not in ALLOWED_ATTR_KEYS:
            raise ValueError(
                f"span attribute {key!r} is not in ALLOWED_ATTR_KEYS; "
                f"telemetry only carries whitelisted structural fields")
        if isinstance(val, bool):
            out[key] = val
        elif isinstance(val, (int, np.integer)):
            out[key] = int(val)
        elif isinstance(val, (float, np.floating)):
            out[key] = float(val)
        elif isinstance(val, str):
            if len(val) > _MAX_STR:
                raise ValueError(
                    f"span attribute {key!r} string exceeds {_MAX_STR} "
                    f"chars; payloads are not loggable")
            out[key] = val
        else:
            raise TypeError(
                f"span attribute {key!r} has non-scalar type "
                f"{type(val).__name__}; arrays/bytes/collections are "
                f"never loggable (redaction contract)")
    return out


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed interval.  ``track`` picks the timeline row in the
    Chrome-trace export ("engine", "admitter", or "request-<id>");
    ``attrs`` passed `validate_attrs` at record time."""
    name: str
    track: str
    t_start: float
    duration_s: float
    request_id: Optional[int] = None
    batch_id: Optional[int] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def t_end(self) -> float:
        return self.t_start + self.duration_s


class Tracer:
    """Bounded, thread-safe span sink with per-stage histograms.

    ``clock`` must be the same monotonic clock the engine stamps
    ``t_enqueue`` with, so queue-wait spans and stage spans share one
    timeline (the engine passes its own clock in).
    """

    enabled = True

    def __init__(self, *, capacity: int = 65536, clock=time.monotonic,
                 common: Optional[dict] = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        # attrs stamped onto every span/event from this tracer (e.g. the
        # router gives each replica's tracer common={"replica": r}) — same
        # redaction contract as per-call attrs; per-call keys win
        self.common = validate_attrs(common or {})
        self.dropped = 0             # spans evicted by the ring bound
        self._spans: deque = deque(maxlen=capacity)
        self._hist: Dict[str, StageHistogram] = {}
        # exact per-name marker counts (shed, rate_limited, refill,
        # quarantine, ...): events carry operational signal — a shed
        # count must survive the ring wrapping just like the histograms
        self._events: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def record(self, name: str, t_start: float, t_end: float, *,
               track: str = "engine", request_id: Optional[int] = None,
               batch_id: Optional[int] = None, **attrs) -> Span:
        """Record a completed interval with explicit timestamps (for
        intervals whose start predates the call, e.g. queue wait measured
        from ``t_enqueue``)."""
        span = Span(name=name, track=track, t_start=float(t_start),
                    duration_s=max(float(t_end) - float(t_start), 0.0),
                    request_id=request_id, batch_id=batch_id,
                    attrs={**self.common, **validate_attrs(attrs)})
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)
            hist = self._hist.get(name)
            if hist is None:
                hist = self._hist[name] = StageHistogram()
            hist.record(span.duration_s)
        return span

    def span(self, name: str, *, track: str = "engine",
             request_id: Optional[int] = None,
             batch_id: Optional[int] = None, **attrs):
        """Time a block.  If the body raises, the span is still recorded —
        with the exception *class name* only — and the exception
        propagates (fault attribution stays visible on the timeline).
        Yields a dict: attrs the body learns (a certificate's ``ok``) are
        put there and recorded with the span.  The block runs inside a
        ``record_function`` range ``repro_torch/<name>``."""
        return _timed(self, name, dict(track=track, request_id=request_id,
                                       batch_id=batch_id, **attrs))

    def bind(self, *, device=None, **span_kw) -> "BoundTracer":
        """This tracer with ``span_kw`` (track, request_id, batch_id,
        attrs) fixed on every span and record made through the
        result.  With a CUDA ``device`` the binding keeps a dispatch's
        device marks (`BoundTracer.mark_device`)."""
        dev = None if device is None else torch.device(device)
        marks = _DeviceMarks() if dev is not None and dev.type == "cuda" \
            else None
        return BoundTracer(self, span_kw, marks)

    def mark_device(self, stage: str, device) -> Optional["torch.cuda.Event"]:
        """A timing event recorded now on ``device``'s current stream, or
        None off CUDA.  Unbound, the event is kept by no one: the caller
        may wait on it."""
        return _cuda_event(device)

    def anchor_device(self) -> None:
        """See `BoundTracer.anchor_device`; unbound, nothing to anchor."""

    def event(self, name: str, *, track: str = "engine",
              request_id: Optional[int] = None,
              batch_id: Optional[int] = None, **attrs) -> Span:
        """Zero-duration marker (quarantine, bisection step, refill grant,
        shard eviction).  Not folded into the stage histograms — a marker
        has no duration to profile."""
        now = self.clock()
        span = Span(name=name, track=track, t_start=float(now),
                    duration_s=0.0, request_id=request_id,
                    batch_id=batch_id,
                    attrs={**self.common, **validate_attrs(attrs)})
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)
            self._events[name] = self._events.get(name, 0) + 1
        return span

    # -- reading ------------------------------------------------------------

    def spans(self) -> List[Span]:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._spans)

    def stage_summary(self) -> dict:
        """{stage: histogram summary} — complete since process start even
        after the span ring wrapped."""
        with self._lock:
            return summarize(self._hist)

    def snapshot(self) -> dict:
        """JSON-ready telemetry snapshot (merged into
        ``ServeMetrics.summary()`` by the engine)."""
        with self._lock:
            return {
                "spans": len(self._spans),
                "dropped": self.dropped,
                "capacity": self.capacity,
                "stages": summarize(self._hist),
                "events": dict(sorted(self._events.items())),
            }

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._hist.clear()
            self._events.clear()
            self.dropped = 0


DEVICE_TRACK = "device"      # the Chrome export's row of <stage>_device spans


@contextmanager
def _timed(tracer: Tracer, name: str, kw: dict):
    """`Tracer.span`'s body, recording through ``tracer.record``."""
    late: dict = {}
    t0 = tracer.clock()
    try:
        with record_function(f"repro_torch/{name}"):
            yield late
    except Exception as e:
        tracer.record(name, t0, tracer.clock(),
                      **{**kw, **late, "error_type": type(e).__name__})
        raise
    tracer.record(name, t0, tracer.clock(), **{**kw, **late})


def _cuda_event(device) -> Optional["torch.cuda.Event"]:
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _DeviceMarks:
    """One dispatch's device marks: (stage, event) in the order recorded,
    and the anchor (an event recorded on a drained stream, with the host
    clock read beside it)."""

    def __init__(self) -> None:
        self.marks: List[tuple] = []
        self.anchor: Optional[tuple] = None


class BoundTracer:
    """A `Tracer` with span keywords fixed (`Tracer.bind`), passed down as
    ``tracer=`` to the code that records sub-spans.  Records through the
    tracer's own ``record``, so a subclass's override of it sees every
    sub-span."""

    enabled = True

    def __init__(self, tracer: Tracer, span_kw: dict,
                 marks: Optional[_DeviceMarks] = None) -> None:
        self.tracer = tracer
        self.clock = tracer.clock
        self._kw = span_kw
        self._marks = marks

    def span(self, name: str, **kw):
        return _timed(self.tracer, name, {**self._kw, **kw})

    def record(self, name: str, t_start: float, t_end: float, **kw):
        return self.tracer.record(name, t_start, t_end, **{**self._kw, **kw})

    def bind(self, **span_kw) -> "BoundTracer":
        """A narrower binding that shares this one's device marks."""
        return BoundTracer(self.tracer, {**self._kw, **span_kw}, self._marks)

    def mark_device(self, stage: str, device) -> Optional["torch.cuda.Event"]:
        """Record a timing event now on ``device``'s current stream (None
        off CUDA): the device end of ``stage``, kept in the binding's
        marks when it has them."""
        ev = _cuda_event(device)
        if ev is not None and self._marks is not None:
            self._marks.marks.append((stage, ev))
        return ev

    def anchor_device(self) -> None:
        """Right after a blocking copy to the host: the stream is drained,
        so an event recorded now runs at the host clock's reading beside
        it, to within a launch.  Maps the marks onto the tracer's clock."""
        if self._marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.anchor = (ev, self.clock())

    def device_time(self, ev: "torch.cuda.Event") -> Optional[float]:
        """The tracer's clock when timing event ``ev`` ran on the device,
        by the binding's anchor (None before `anchor_device`).  The anchor
        must be complete."""
        m = self._marks
        if m is None or m.anchor is None:
            return None
        anchor, t_anchor = m.anchor
        return t_anchor - ev.elapsed_time(anchor) / 1e3

    def record_device_spans(self, stages, **attrs) -> int:
        """``<stage>_device`` spans on the ``device`` track, one for each
        of ``stages``: from the previous mark's device time (the first
        mark opens the first) to the stage's own.  The marks must be a
        start mark followed by ``stages`` once each, in order, and the
        anchor must be complete (it is, once a blocking copy returned; no
        synchronisation here): otherwise nothing is recorded.  Returns the
        number of spans recorded."""
        m = self._marks
        if m is None or m.anchor is None or \
                [s for s, _ in m.marks[1:]] != list(stages):
            return 0
        if not m.anchor[0].query():
            return 0
        ends = [self.device_time(ev) for _, ev in m.marks]
        for stage, t0, t1 in zip(stages, ends, ends[1:]):
            self.record(f"{stage}_device", t0, t1, track=DEVICE_TRACK,
                        **attrs)
        return len(stages)


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None         # no late attrs to keep

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op sink so instrumented code needs no ``if traced:`` branches.
    All record/span/event calls reduce to returning a shared constant."""

    enabled = False
    capacity = 0
    dropped = 0
    common: dict = {}
    clock = staticmethod(time.monotonic)

    def record(self, name, t_start, t_end, **kwargs):
        return None

    def span(self, name, **kwargs):
        return _NULL_SPAN

    def event(self, name, **kwargs):
        return None

    def bind(self, **kwargs):
        return self

    def mark_device(self, stage, device):
        return None

    def anchor_device(self):
        pass

    def record_device_spans(self, stages, **attrs):
        return 0

    def spans(self):
        return []

    def stage_summary(self):
        return {}

    def snapshot(self):
        return {"spans": 0, "dropped": 0, "capacity": 0, "stages": {},
                "events": {}}

    def clear(self):
        pass


NULL_TRACER = NullTracer()

__all__ = ["ALLOWED_ATTR_KEYS", "validate_attrs", "Span", "Tracer",
           "BoundTracer", "NullTracer", "NULL_TRACER", "DEVICE_TRACK"]
