"""Finds a configuration's knee once, on the chip: the highest Poisson
rate at which the backlog does not grow through the window.

    python3 rag_bench/sweep.py --workload <paced cell> --seed <n> --seconds <s> --rates r1,r2,...

Builds the cell's program once, then offers each rate for ``--seconds``
(arrivals from the harness's generator) and prints one JSON line a rate:
requests sent and answered in the window, the backlog (sent, not yet
answered) at the window's close, and the latency median and 95th
percentile of each half of the window.  A rate whose backlog at the close
is within one batch and whose second half's 95th percentile is within a
quarter of its first half's is sustained; the cell's traffic file takes
0.8 of the highest such rate."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    from rag_bench import harness, schedule
    from rag_bench.stats import percentile

    ap = argparse.ArgumentParser(description="the knee of a paced cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    st = harness.build(args.workload, seed=args.seed, trace=False,
                       device="cuda")
    program = st.program
    max_batch = st.cfg["engine"]["max_batch"]
    for j, rate in enumerate(float(r) for r in args.rates.split(",")):
        sched = schedule.make({"kind": "poisson", "rate_rps": rate},
                              seed=args.seed + j, seconds=args.seconds,
                              pool=len(program.pool),
                              tenants=len(program.tenants))
        run = harness.Run(seconds=args.seconds, setup_s=0.0)
        rids = {}
        # the window only: arrivals past it are not offered
        cut = int((sched.arrivals < args.seconds).sum())
        sched = schedule.Schedule(kind="poisson", clients=0,
                                  arrivals=sched.arrivals[:cut],
                                  query=sched.query[:cut],
                                  tenant=sched.tenant[:cut],
                                  key=sched.key[:cut])
        harness.drive(program, run, sched,
                      harness.submitter(program, run, sched, rids),
                      harness.finisher(program, run, rids))
        backlog = sum(1 for i in run.due if run.done.get(i, 1e18) > run.t_end)
        halves = []
        for lo, hi in ((0, 0.5), (0.5, 1.0)):
            lat = [(run.done[i] - run.due[i]) * 1e3 for i in run.due
                   if lo <= (run.due[i] - run.t0) / args.seconds < hi]
            halves.append([percentile(lat, 50), percentile(lat, 95)])
        print(json.dumps(dict(
            rate=rate, sent=len(run.due),
            answered_in_window=run.completed_by(run.t_end), backlog=backlog,
            p50_p95_first_half=halves[0], p50_p95_second_half=halves[1],
            sustained=bool(backlog <= max_batch
                           and halves[1][1] <= 1.25 * halves[0][1]))),
              flush=True)
        time.sleep(1.0)
    program.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
