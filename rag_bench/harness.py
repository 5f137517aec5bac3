"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

The harness knows no program.  A cell's configuration module,
``configs/<name>.py``, brings one as ``make_program(cfg, cell, seed,
device, tracer)``; a module that gives only ``make_inputs`` gets the
private retrieval round of ``rag_round.py``.  ``make_program`` builds the
program and warms it up on the cell's ``warmup`` (so its set-up falls
inside ``setup_s``) and returns an object with:

* ``pool``: the payloads the schedule draws from, and ``tenants``: the
  tenants ``submit`` takes (request ``i`` sends ``pool[query[i]]`` for
  ``tenants[tenant[i]]``);
* ``shapes``: a dict, ``Run.shapes`` for the metric readers;
* ``submit(tenant, payload, key) -> request id`` (``key`` a 62-bit draw
  from the seed);
* ``step()`` and ``drain()``: the results that are done, each with ``ok``
  and ``request_id``, and ``transcript.total_bytes`` (the bytes a request
  put on the wire, read by ``wire_kb_per_request``); ``pending``;
* optionally ``on_results(results)``, called on each step's results in
  the order they came;
* ``close()``: frees the program's device state before the reference runs;
* ``check(run, served, sched, seed) -> {name: number}``: after ``close``,
  the numbers compared with the plain reference, one for each key of the
  cell's ``limits`` (the harness raises on any other set of names);
  ``correct`` is every number at or below its limit.

The window drives the program on this one thread, every time read from
``time.perf_counter``; it reads ``submit``, ``step`` and ``pool`` once,
when it starts.  A closed loop's clients each send their next
request when their last reply is back; an open loop sends each request
when it is due and times it from then, however late the loop got to it."""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import guard, manifest, rag_round, schedule

CLOCK = time.perf_counter
GRACE_S = 60.0          # an open loop waits this long past the window


@dataclasses.dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    seconds: float
    setup_s: float
    t0: float = 0.0
    t_end: float = 0.0
    t_close: float = 0.0
    due: Dict[int, float] = dataclasses.field(default_factory=dict)
    sent: Dict[int, float] = dataclasses.field(default_factory=dict)
    done: Dict[int, float] = dataclasses.field(default_factory=dict)
    result: Dict[int, object] = dataclasses.field(default_factory=dict)
    shapes: dict = dataclasses.field(default_factory=dict)
    tracer: object = None           # devtrace.stage_tracer, traced runs
    device: Optional[dict] = None   # devtrace.analyse, traced runs

    def ok(self, i: int) -> bool:
        r = self.result.get(i)
        return r is not None and r.ok

    def latencies_ms(self) -> List[float]:
        """Every request due in the window: scheduled send to result, a
        failed or unanswered one as infinite."""
        return [(self.done[i] - self.due[i]) * 1e3 if self.ok(i)
                else math.inf for i in self.due]

    def completed_by(self, t: float) -> int:
        return sum(1 for i, d in self.done.items()
                   if d <= t and self.ok(i))


def submitter(program, run: Run, sched, rids: Dict[int, int]):
    """``submit(i, due)``: request ``i`` of ``sched`` into ``program``,
    its due and send times into ``run``, its request id into ``rids``."""
    send, pool, tenants = program.submit, program.pool, program.tenants

    def submit(i: int, due: float) -> None:
        run.due[i] = due
        run.sent[i] = CLOCK()
        rid = send(tenants[int(sched.tenant[i])], pool[int(sched.query[i])],
                   int(sched.key[i]))
        rids[rid] = i
    return submit


def finisher(program, run: Run, rids: Dict[int, int]):
    """``finish(results, now)``: one step's results to the program's
    ``on_results``, where it has one, then each into ``run``."""
    on_results = getattr(program, "on_results", None)

    def finish(results, now: float) -> None:
        if on_results is not None:
            on_results(results)
        for r in results:
            i = rids.get(r.request_id)
            if i is not None and i not in run.result:
                run.result[i] = r
                run.done[i] = now
    return finish


def drive(program, run: Run, sched, submit, finish,
          sleep=time.sleep) -> None:
    """The measured window, closed or open loop (see the module's
    docstring); ``finish(results, now)`` takes each step's results.
    Leaves what is still queued for the drain."""
    step = program.step
    t0 = CLOCK()
    run.t0, run.t_end = t0, t0 + run.seconds
    if sched.kind == "closed":
        nxt = 0
        for _ in range(sched.clients):
            submit(nxt, t0)
            nxt += 1
        while CLOCK() < run.t_end:
            res = step()
            now = CLOCK()
            if not res:
                sleep(0.0002)
                continue
            finish(res, now)
            for _ in res:
                if now < run.t_end and nxt < sched.size:
                    submit(nxt, now)
                    nxt += 1
    else:
        arrivals = sched.arrivals
        i, n = 0, sched.size
        while True:
            now = CLOCK()
            while i < n and t0 + arrivals[i] <= now:
                submit(i, t0 + arrivals[i])
                i += 1
            res = step()
            done = CLOCK()
            if res:
                finish(res, done)
            if (i >= n and program.pending == 0) or done > run.t_end + GRACE_S:
                break
            if not res:
                wait = t0 + arrivals[i] - done if i < n else 0.0
                sleep(min(max(wait, 0.0), 0.0005))
    run.t_close = CLOCK()


@dataclasses.dataclass
class Setup:
    """A cell's program, built and warmed up, with what it was made from."""
    cell: dict
    cfg: dict
    traffic: dict
    program: object
    tracer: object
    device: object


def build(cell_name: str, *, seed: int, trace: bool, device,
          config_overrides: Optional[dict] = None) -> Setup:
    """The cell's files, the stage tracer of a traced run, and the
    program from ``make_program`` (the RLWE round where the configuration
    module has none)."""
    import torch

    from . import devtrace

    cell = manifest.load_json("cells", cell_name)
    cfg = {**manifest.load_json("configs", cell["config"]),
           **(config_overrides or {})}
    traffic = manifest.load_json("traffic", cell["traffic"])
    builder = manifest.load_module("configs", cell["config"])
    make_program = getattr(builder, "make_program", None) or functools.partial(
        rag_round.RagRound, make_inputs=builder.make_inputs)
    dev = torch.device(device)
    tracer = None
    if trace:
        from repro_torch import obs
        tracer = devtrace.stage_tracer(obs, CLOCK)
    program = make_program(cfg, cell, seed, dev, tracer)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return Setup(cell=cell, cfg=cfg, traffic=traffic, program=program,
                 tracer=tracer, device=dev)


def run_cell(cell_name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, config_overrides: dict = None,
             fault: Optional[Callable] = None, log=sys.stderr) -> dict:
    """One run; returns the result object (``checks`` last).  ``fault``
    (tests) is applied before the window to the program's ``engine``
    where it has one, else to the program."""
    import torch

    from . import devtrace

    t_start = CLOCK() if t_start is None else t_start
    bench = manifest.benchmark() if bench is None else bench
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = build(cell_name, seed=seed, trace=trace, device=device,
               config_overrides=config_overrides)
    cell, program, tracer, dev = st.cell, st.program, st.tracer, st.device
    if fault is not None:
        fault(getattr(program, "engine", program))
    sched = schedule.make(st.traffic, seed=seed, seconds=seconds,
                          pool=len(program.pool),
                          tenants=len(program.tenants))
    run = Run(seconds=seconds, setup_s=0.0, shapes=program.shapes)
    rids: Dict[int, int] = {}
    finish = finisher(program, run, rids)

    gc.collect()
    gc.freeze()
    prof = devtrace.Profile() if trace else None
    run.setup_s = CLOCK() - t_start
    if trace:
        tracer.open = True
        prof.start()
    drive(program, run, sched, submitter(program, run, sched, rids), finish)
    if trace:
        prof.stop()
        tracer.open = False
    finish(program.drain(), CLOCK())
    device_info = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                       kind=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                       count=1,
                       memory_peak_bytes=(torch.cuda.max_memory_allocated(dev)
                                          if dev.type == "cuda" else 0))
    if trace:
        run.tracer = tracer
        run.device = devtrace.analyse(prof.events, prof.window_ns,
                                      torch.autograd.DeviceType.CUDA)
        del prof
        if run.device["busy_s"] <= 0:
            raise RuntimeError("the profiler saw no operation on the device "
                               "in the window")
        device_info.update(busy_s=run.device["busy_s"],
                           window_s=run.device["window_s"])
    served = {i: r for i, r in run.result.items() if r.ok}
    _report_loop(run, sched, log)

    # the program's state goes before the reference runs
    program.close()
    del st
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    nums = program.check(run, served, sched, seed)
    limits = cell["limits"]
    if set(nums) != set(limits):
        raise ValueError(f"{cell_name}: the program's check gives "
                         f"{sorted(nums)}, the cell's limits {sorted(limits)}")
    checks = {name: {"value": float(v), "limit": float(limits[name])}
              for name, v in nums.items()}

    metrics = {}
    entries = (manifest.per_layer(bench, cell_name) if trace
               else manifest.end_to_end(bench, cell_name))
    for m in entries:
        value = manifest.load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted = len(run.due)
    failed = attempted - len(served)
    out = dict(correct=all(v["value"] <= v["limit"] for v in checks.values()),
               attempted=attempted, failed=failed, metrics=metrics,
               device=device_info)
    if trace:
        out["breakdown"] = dict(device_ops=run.device["device_ops"],
                                idle_gaps=run.device["idle_gaps"])
    out["checks"] = checks
    return out


def _report_loop(run: Run, sched, log) -> None:
    late = [run.sent[i] - run.due[i] for i in run.due]
    print(f"loop: {sched.kind}, {len(run.due)} sent, "
          f"{run.completed_by(run.t_end)} completed in the window, "
          f"generator late by mean {np.mean(late) * 1e3:.3f} ms, "
          f"max {np.max(late) * 1e3:.3f} ms; closed "
          f"{(run.t_close - run.t_end) * 1e3:.1f} ms after the window",
          file=log)


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.benchmark()
    chips = manifest.workload(bench, args.workload)["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rag_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # load from one process with few threads: the round's host work runs
    # on this one thread
    torch.set_num_threads(1)
    out = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), t_start=t_start, bench=bench)
    found = guard.loaded_forbidden()
    if found:
        print(f"rag_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
