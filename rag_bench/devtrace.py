"""The traced run's instruments: a stage tracer injected into the engine
and the reading of one profiler session over the window.

`stage_tracer` makes an ``obs.Tracer`` whose stage spans also open a
``torch.profiler.record_function`` range of the stage's name, and which
sums, while its window is open, each stage's host seconds, the lanes of
each batched stage and the lanes of each dispatch.  `Profile` runs one
``torch.profiler`` session (CPU and CUDA activity) over the window and
keeps its events in memory; `analyse` reduces them: the device's busy
time is the union of the intervals of every operation that ran on the
device, and a stage's device time is the union of the intervals of the
operations launched while the stage's range was open on the host (by the
launch call's correlation id), so it reads the same work whatever kernel
runs there."""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .stats import gaps, union_length

STAGES = ("perturb", "topk", "encrypt", "score", "decrypt", "finish")


def stage_tracer(obs, clock):
    """An ``obs.Tracer`` on ``clock`` (the engine's) with the stage ranges
    and sums described above; ``open`` gates the sums."""
    from torch.profiler import record_function

    class StageTracer(obs.Tracer):
        def __init__(self):
            super().__init__(capacity=4096, clock=clock)
            self.open = False
            self.seconds: Dict[str, float] = collections.defaultdict(float)
            self.count: Dict[str, int] = collections.Counter()
            self.lanes: Dict[str, List[int]] = collections.defaultdict(list)

        @contextlib.contextmanager
        def span(self, name, **kw):
            if name not in STAGES:
                with super().span(name, **kw):
                    yield
                return
            with record_function(name):
                with super().span(name, **kw):
                    yield

        def record(self, name, t_start, t_end, **kw):
            span = super().record(name, t_start, t_end, **kw)
            if self.open:
                self.seconds[name] += span.duration_s
                self.count[name] += 1
                lanes = span.attrs.get("lanes", span.attrs.get("batch_size"))
                if lanes is not None:
                    self.lanes[name].append(int(lanes))
            return span

    return StageTracer()


class Profile:
    """One profiler session: `start`, `stop`, then `events` and the
    window's bounds in the profiler's clock (ns)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.window_ns: Tuple[int, int] = (0, 0)

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter_ns()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        held = time.perf_counter_ns() - self._t0
        self._prof.stop()
        res = self._prof.profiler.kineto_results
        lo = int(res.trace_start_ns())
        self.window_ns = (lo, lo + held)
        self.events = res.events()


def analyse(events: Sequence, window_ns: Tuple[int, int], cuda_type,
            stages: Sequence[str] = STAGES) -> dict:
    """Busy seconds, each stage's device seconds, and the breakdown
    (top device operations, idle time by the host's open stage) from
    kineto events (``name()``, ``device_type()``, ``start_ns()``,
    ``duration_ns()``, ``end_ns()``, ``correlation_id()``,
    ``is_user_annotation()``)."""
    lo, hi = window_ns
    ranges: List[Tuple[int, int, str]] = []
    launch: Dict[int, int] = {}
    dev: List[Tuple[int, int, int, str]] = []
    for e in events:
        name = e.name()
        if e.device_type() == cuda_type:
            if e.is_user_annotation():
                continue
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.correlation_id(), name))
        elif e.is_user_annotation():
            if name in stages:
                ranges.append((e.start_ns(), e.end_ns(), name))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]

    def open_stage(t: int) -> Optional[str]:
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and ranges[j][0] <= t < ranges[j][1]:
            return ranges[j][2]
        return None

    def clip(s, e):
        return max(s, lo), min(e, hi)

    all_iv = []
    per_stage: Dict[str, list] = collections.defaultdict(list)
    by_name: Dict[str, int] = collections.Counter()
    for s, e, corr, name in dev:
        cs, ce = clip(s, e)
        if ce <= cs:
            continue
        all_iv.append((cs, ce))
        by_name[name] += ce - cs
        stage = open_stage(launch.get(corr, s))
        if stage is not None:
            per_stage[stage].append((cs, ce))
    busy = union_length(all_iv)
    idle: Dict[str, int] = collections.Counter()
    for s, e in gaps(all_iv, lo, hi):
        idle[open_stage((s + e) // 2) or "no stage"] += e - s
    return dict(
        busy_s=busy / 1e9, window_s=(hi - lo) / 1e9,
        stage_device_s={k: union_length(v) / 1e9
                        for k, v in per_stage.items()},
        device_ops=[[n[:160], t / 1e9] for n, t in by_name.most_common(10)],
        idle_gaps=[[n, t / 1e9] for n, t in idle.most_common(10)])
