"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

from typing import Callable, Optional


def stage_ms_per_request(run, stage: str) -> Optional[float]:
    """Host milliseconds of ``stage``'s spans over the traced window, per
    request completed in it."""
    t = run.tracer
    done = run.completed_by(run.t_close)
    if t is None or not done or not t.count.get(stage):
        return None
    return 1e3 * t.seconds[stage] / done


def roofline(run, stage: str,
             bound: Callable[[int], float]) -> Optional[float]:
    """Percent: the least time of every ``stage`` span's batch
    (``bound(lanes)`` seconds) over the stage's device time.  Nothing when
    the stage ran nothing on the device."""
    t, d = run.tracer, run.device
    lanes = t.lanes.get(stage) if t is not None else None
    dev_s = (d or {}).get("stage_device_s", {}).get(stage, 0.0)
    if not lanes or dev_s <= 0:
        return None
    return 100.0 * sum(bound(n) for n in lanes) / dev_s
