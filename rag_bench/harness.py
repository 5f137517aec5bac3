"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

The window drives the port's serving entry, `repro_torch.serve.ServeEngine`,
over a `FlatIndex` with the dense NTT-domain candidate cache: each request
goes in through ``submit(tenant, embedding, key=<from the seed>)`` and
comes back from ``step`` or ``drain``, on this one thread.  Every time is
read from ``time.perf_counter``, which the engine is given as its clock.
A closed loop's clients each send their next request when their last
reply is back; an open loop sends each request when it is due and times it
from then, however late the loop got to it."""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from . import guard, manifest, schedule
from .reference import check as refcheck
from .reference import plan as refplan

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


class FetchLog:
    """The candidate ids of every reply, read where the user fetches its
    documents: ``RemoteRagCloud.handle_fetch(candidate_ids, FetchDirect)``
    on the engine's cloud, wrapped.  Records made on the stepping thread
    pair in order with the completed lanes a ``step`` returns; a retry
    lane's records pair by content."""

    def __init__(self, cloud):
        self._main = threading.get_ident()
        self._ordered: deque = deque()
        self._other: list = []
        inner = cloud.handle_fetch

        def handle_fetch(cand_ids, msg):
            rec = (np.array(cand_ids, copy=True),
                   [int(p) for p in msg.positions])
            if threading.get_ident() == self._main:
                self._ordered.append(rec)
            else:
                self._other.append(rec)
            return inner(cand_ids, msg)

        cloud.handle_fetch = handle_fetch

    def pair(self, results) -> Dict[int, np.ndarray]:
        """{request id: candidate ids} for the ok results of one step."""
        out = {}
        for r in results:
            if not r.ok:
                continue
            ids = np.asarray(r.ids).reshape(-1)
            if not r.quarantined and self._ordered:
                cand, pos = self._ordered.popleft()
            else:
                match = [j for j, (c, p) in enumerate(self._other)
                         if np.array_equal(c[p], ids)]
                if not match:
                    continue
                cand, pos = self._other.pop(match[0])
            if np.array_equal(cand[pos], ids):
                out[r.request_id] = cand
        return out


def submitter(engine, run: Run, sched, queries, rids: Dict[int, int]):
    """``submit(i, due)``: request ``i`` of ``sched`` into ``engine``,
    its due and send times into ``run``, its request id into ``rids``."""
    def submit(i: int, due: float) -> None:
        run.due[i] = due
        run.sent[i] = CLOCK()
        rid = engine.submit(f"tenant-{int(sched.tenant[i])}",
                            queries[int(sched.query[i])],
                            key=int(sched.key[i]))
        rids[rid] = i
    return submit


def drive(engine, run: Run, sched, submit, finish,
          sleep=time.sleep) -> None:
    """The measured window, closed or open loop (see the module's
    docstring); ``finish(results, now)`` takes each step's results.
    Leaves what is still queued for the drain."""
    t0 = CLOCK()
    run.t0, run.t_end = t0, t0 + run.seconds
    if sched.kind == "closed":
        nxt = 0
        for _ in range(sched.clients):
            submit(nxt, t0)
            nxt += 1
        while CLOCK() < run.t_end:
            res = engine.step()
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
            res = engine.step()
            done = CLOCK()
            if res:
                finish(res, done)
            if (i >= n and engine.pending == 0) or done > run.t_end + GRACE_S:
                break
            if not res:
                wait = t0 + arrivals[i] - done if i < n else 0.0
                sleep(min(max(wait, 0.0), 0.0005))
    run.t_close = CLOCK()


@dataclasses.dataclass
class Setup:
    """A cell's program, built and warmed up: the engine over its index,
    and the inputs it was made from."""
    cell: dict
    cfg: dict
    traffic: dict
    inputs: dict
    engine: object
    index: object
    tracer: object
    device: object
    kprime: int


def build(cell_name: str, *, seed: int, trace: bool, device,
          config_overrides: Optional[dict] = None) -> Setup:
    """Inputs from the seed, the index, the engine with its sessions, and
    the warm-up batches (the cell's own shapes, off the window's
    streams)."""
    import torch

    from repro_torch import obs
    from repro_torch.crypto.rlwe import RlweParams
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

    from . import devtrace

    cell = manifest.load_json("cells", cell_name)
    cfg = {**manifest.load_json("configs", cell["config"]),
           **(config_overrides or {})}
    traffic = manifest.load_json("traffic", cell["traffic"])
    builder = manifest.load_module("configs", cell["config"])
    dev = torch.device(device)
    inputs = builder.make_inputs(cfg, seed, dev)
    queries = inputs["queries"]
    index = FlatIndex.build(inputs["corpus"], documents=inputs["documents"],
                            normalize=False, device=dev)
    params = RlweParams(**cfg["rlwe"])
    eng_cfg = cfg["engine"]
    tracer = devtrace.stage_tracer(obs, CLOCK) if trace else None
    engine = ServeEngine(
        index, config=EngineConfig(max_batch=eng_cfg["max_batch"],
                                   max_wait_s=eng_cfg["max_wait_s"],
                                   refill=eng_cfg["refill"]),
        sessions=SessionManager(rlwe_params=params, deterministic_seeds=True,
                                device=dev),
        clock=CLOCK, tracer=tracer)
    tenants = eng_cfg["tenants"]
    knob = cfg["plan"]
    plan_kw = ({"plan_kwargs": {"kprime": knob["kprime"]}}
               if "kprime" in knob else {"radius": knob["radius"]})
    for t in range(tenants):
        engine.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                            k=cfg["k"], seed=schedule.sub_seed(seed, 100 + t),
                            **plan_kw)
    wkeys = np.random.default_rng(schedule.sub_seed(seed, 4))
    for size in cell["warmup"]:
        for j in range(size):
            engine.submit(f"tenant-{j % tenants}",
                          queries[int(wkeys.integers(len(queries)))],
                          key=int(wkeys.integers(1 << 62)))
        engine.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return Setup(cell=cell, cfg=cfg, traffic=traffic, inputs=inputs,
                 engine=engine, index=index, tracer=tracer, device=dev,
                 kprime=engine.sessions.get("tenant-0").plan.kprime)


def run_cell(cell_name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             bench: Optional[dict] = None, config_overrides: dict = None,
             fault: Optional[Callable] = None, log=sys.stderr) -> dict:
    """One run; returns the result object (``checks`` last).  ``fault``
    (tests) is applied to the engine before the window."""
    import torch

    from . import devtrace

    t_start = CLOCK() if t_start is None else t_start
    bench = manifest.benchmark() if bench is None else bench
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    st = build(cell_name, seed=seed, trace=trace, device=device,
               config_overrides=config_overrides)
    cell, cfg, traffic, inputs = st.cell, st.cfg, st.traffic, st.inputs
    engine, index, tracer, dev = st.engine, st.index, st.tracer, st.device
    queries = inputs["queries"]
    tenants = cfg["engine"]["tenants"]
    n_rows, dim, kprime = index.num_rows, index.dim, st.kprime
    fetches = FetchLog(engine.cloud)
    if fault is not None:
        fault(engine)
    sched = schedule.make(traffic, seed=seed, seconds=seconds,
                          pool=len(queries), tenants=tenants)
    run = Run(seconds=seconds, setup_s=0.0,
              shapes=dict(rows=n_rows, dim=dim, kprime=kprime,
                          rlwe=cfg["rlwe"]))
    rids: Dict[int, int] = {}
    cands: Dict[int, np.ndarray] = {}

    def finish(res, now: float) -> None:
        i = rids.get(res.request_id)
        if i is not None and i not in run.result:
            run.result[i] = res
            run.done[i] = now

    def finish_step(results, now):
        # one step's results pair in order with its fetch records
        cands.update(fetches.pair(results))
        for r in results:
            finish(r, now)

    gc.collect()
    gc.freeze()
    prof = devtrace.Profile() if trace else None
    run.setup_s = CLOCK() - t_start
    if trace:
        tracer.open = True
        prof.start()
    drive(engine, run, sched, submitter(engine, run, sched, queries, rids),
          finish_step)
    if trace:
        prof.stop()
        tracer.open = False
    finish_step(engine.drain(), CLOCK())
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
    engine.close()
    del engine, index, fetches, st
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = _check(cell, cfg, run, served, cands, inputs, queries, sched,
                    seed, dev)

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


def _check(cell, cfg, run: Run, served, cands, inputs, queries, sched,
           seed: int, dev) -> dict:
    """The numbers compared, each beside its limit (see
    ``reference/check.py``)."""
    k, dim, n_rows = cfg["k"], run.shapes["dim"], run.shapes["rows"]
    plan = refplan.from_knob(cfg["plan"], n=dim, N=n_rows, k=k)
    if plan.use_ot:
        raise ValueError("the reference covers the direct path only")
    docs_fmt = cfg["documents"]
    rows = []
    for i, r in served.items():
        t = r.transcript
        rows.append(refcheck.Served(
            query=queries[int(sched.query[i])], key=int(sched.key[i]),
            cand_ids=cands.get(r.request_id), ids=np.asarray(r.ids),
            docs=list(r.docs),
            transcript=None if t is None else dict(
                request_bytes=t.request_bytes, reply_bytes=t.reply_bytes,
                fetch_bytes=t.fetch_bytes, docs_bytes=t.docs_bytes,
                ot_wire_bytes=t.ot_wire_bytes)))
    limits = cell["limits"]
    nums = dict(missing=len(run.due) - len(served),
                doc_errors=refcheck.document_errors(rows, docs_fmt),
                wire_errors=refcheck.wire_errors(
                    rows, dim=dim, kprime=plan.kprime, k=k,
                    doc_format=docs_fmt, rlwe=cfg["rlwe"]))
    rng = np.random.default_rng(schedule.sub_seed(seed, 3))
    take = min(cell["check_sample"], len(rows))
    sample = [rows[j] for j in sorted(rng.choice(len(rows), take,
                                                 replace=False))]
    if sample:
        corpus = inputs["reference_corpus"]()
        pert = refcheck.perturbed(sample, plan.eps, dev)
        nums.update(refcheck.gaps(corpus, sample, pert, k=k,
                                  kprime=plan.kprime))
        del corpus
    else:
        nums.update(cand_gap=math.inf, topk_gap=math.inf)
    return {name: {"value": float(nums[name]), "limit": float(limits[name])}
            for name in ("missing", "cand_gap", "topk_gap", "doc_errors",
                         "wire_errors")}


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
