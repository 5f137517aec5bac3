"""The control of ``correct``: the plain reference put in the program's
place in bfloat16, the precision below the configuration's float32, read
by the same numbers as a run (``reference/check.py``).  A limit holds
only if this reads above it.

    python3 rag_bench/control.py --workload <cell> --seeds s1,s2,...

For each seed: the cell's inputs and the first ``check_sample`` requests
of its schedule, the bfloat16 reference's candidates and served ids for
them, and one JSON line of their ``cand_gap`` and ``topk_gap``, beside the
float32 reference's own (which read 0).  Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def readings(cell_name: str, seed: int, *, device="cuda",
             config_overrides: dict = None, seconds: float = None,
             sample: int = None) -> dict:
    import torch

    from rag_bench import manifest, schedule
    from rag_bench.reference import check, plan as refplan

    bench = manifest.benchmark()
    cell = manifest.load_json("cells", cell_name)
    cfg = {**manifest.load_json("configs", cell["config"]),
           **(config_overrides or {})}
    traffic = manifest.load_json("traffic", cell["traffic"])
    dev = torch.device(device)
    inputs = manifest.load_module("configs", cell["config"]).make_inputs(
        cfg, seed, dev)
    queries = inputs["queries"]
    sched = schedule.make(traffic, seed=seed,
                          seconds=seconds or bench["run_seconds"],
                          pool=len(queries), tenants=cfg["engine"]["tenants"])
    n_rows, dim, k = inputs["corpus"].shape[0], queries.shape[1], cfg["k"]
    plan = refplan.from_knob(cfg["plan"], n=dim, N=n_rows, k=k)
    take = min(sample or cell["check_sample"], sched.size)
    served = [check.Served(query=queries[int(sched.query[i])],
                           key=int(sched.key[i]), cand_ids=None, ids=None,
                           docs=[], transcript=None) for i in range(take)]
    del inputs["corpus"]
    corpus = inputs["reference_corpus"]()
    pert = check.perturbed(served, plan.eps, dev)
    out = dict(cell=cell_name, seed=seed, requests=take, kprime=plan.kprime)
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        with check._fp32_exact():
            picked = check.control(corpus, served, pert, k=k,
                                   kprime=plan.kprime, dtype=dtype)
        nums = check.gaps(corpus, picked, pert, k=k, kprime=plan.kprime)
        out.update({f"{key}.{name}": v for key, v in nums.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
