"""Chrome-trace-format export: load the serving timeline in Perfetto.

`write_chrome_trace` turns a tracer's span snapshot into the Trace Event
Format JSON that ``ui.perfetto.dev`` (or ``chrome://tracing``) renders
directly: complete ("X") duration events in microseconds, one thread row
per span *track* — "engine" for batched stages, "admitter" for the
sharded cache's background thread, "request-<id>" rows for per-request
spans — so a batch's lane-parallel structure and the admission copy
overlapping encrypt are visible on a real timeline.  The ``device`` track
(the ``<stage>_device`` spans: where each batched step ended on the card)
is a process row of its own, below the host's.

Only the span schema's whitelisted scalars reach ``args``; the exporter
adds nothing beyond ids already on the span.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.trace import DEVICE_TRACK, Span

_PID = 1                         # single-process engine
_DEVICE_PID = 2                  # the card's row


def chrome_trace_events(spans: Sequence[Span]) -> List[dict]:
    """Spans -> Trace Event Format event list (ts normalized to the
    earliest span so Perfetto opens at t=0)."""
    if not spans:
        return []
    t0 = min(s.t_start for s in spans)
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for span in spans:
        pid = _DEVICE_PID if span.track == DEVICE_TRACK else _PID
        tid = tids.get(span.track)
        if tid is None:
            # "engine" first keeps the main pipeline as the top row
            tid = tids[span.track] = 1 if span.track in ("engine",
                                                         DEVICE_TRACK) \
                else len(tids) + 1
            if pid == _DEVICE_PID:
                events.append({
                    "name": "process_name", "ph": "M", "pid": pid,
                    "args": {"name": DEVICE_TRACK},
                })
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": span.track},
            })
        args = dict(span.attrs)
        if span.request_id is not None:
            args["request_id"] = span.request_id
        if span.batch_id is not None:
            args["batch_id"] = span.batch_id
        events.append({
            "name": span.name,
            "ph": "X",
            "ts": round((span.t_start - t0) * 1e6, 3),
            "dur": round(span.duration_s * 1e6, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    return events


def write_chrome_trace(path: str, spans: Sequence[Span], *,
                       stage_summary: Optional[dict] = None) -> int:
    """Write ``{"traceEvents": [...]}`` JSON to ``path``; returns the
    number of duration events written.  ``stage_summary`` (if given) is
    attached under ``"metadata"`` so the profile travels with the
    timeline."""
    events = chrome_trace_events(spans)
    doc: dict = {"traceEvents": events, "displayTimeUnit": "ms"}
    if stage_summary is not None:
        doc["metadata"] = {"stage_summary": stage_summary}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return sum(1 for e in events if e.get("ph") == "X")


def load_chrome_trace(path: str) -> dict:
    """Load + structurally validate a trace file written by
    `write_chrome_trace`."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for e in events:
        if e["ph"] == "X" and (e["dur"] < 0 or e["ts"] < 0):
            raise ValueError(f"negative ts/dur in event {e['name']!r}")
    return doc


__all__ = ["chrome_trace_events", "write_chrome_trace", "load_chrome_trace"]
