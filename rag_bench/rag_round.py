"""The private retrieval round: the program of every configuration whose
``configs/<name>.py`` gives ``make_inputs`` and no ``make_program``.

`RagRound` is the port's serving entry, `repro_torch.serve.ServeEngine`,
over a `FlatIndex` with the dense NTT-domain candidate cache and RLWE
sessions, direct fetch: each request goes in through ``submit(tenant,
embedding, key=<from the seed>)`` and comes back from ``step`` or
``drain``.  It holds to the program contract in ``harness.py``'s
docstring, and its ``check`` is ``reference/check.py``'s comparison."""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict

import numpy as np

from . import schedule
from .reference import check as refcheck
from .reference import plan as refplan

# the numbers ``check`` compares, in the order the result line gives them
CHECKS = ("missing", "cand_gap", "topk_gap", "doc_errors", "wire_errors")


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


class RagRound:
    """Built and warmed up on construction: inputs from the seed
    (``make_inputs(cfg, seed, device)``), the index, the engine with its
    sessions, and the warm-up batches (the cell's own shapes, off the
    window's streams); the fetch log goes on after the warm-up.  The
    engine's clock is the harness's, ``time.perf_counter``."""

    def __init__(self, cfg: dict, cell: dict, seed: int, device, tracer, *,
                 make_inputs: Callable):
        from repro_torch.crypto.rlwe import RlweParams
        from repro_torch.retrieval.index import FlatIndex
        from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

        inputs = make_inputs(cfg, seed, device)
        queries = inputs["queries"]
        index = FlatIndex.build(inputs["corpus"],
                                documents=inputs["documents"],
                                normalize=False, device=device)
        params = RlweParams(**cfg["rlwe"])
        eng_cfg = cfg["engine"]
        engine = ServeEngine(
            index, config=EngineConfig(max_batch=eng_cfg["max_batch"],
                                       max_wait_s=eng_cfg["max_wait_s"],
                                       refill=eng_cfg["refill"]),
            sessions=SessionManager(rlwe_params=params,
                                    deterministic_seeds=True, device=device),
            clock=time.perf_counter, tracer=tracer)
        tenants = eng_cfg["tenants"]
        knob = cfg["plan"]
        plan_kw = ({"plan_kwargs": {"kprime": knob["kprime"]}}
                   if "kprime" in knob else {"radius": knob["radius"]})
        for t in range(tenants):
            engine.open_session(f"tenant-{t}", n=index.dim,
                                N=index.num_rows, k=cfg["k"],
                                seed=schedule.sub_seed(seed, 100 + t),
                                **plan_kw)
        wkeys = np.random.default_rng(schedule.sub_seed(seed, 4))
        for size in cell["warmup"]:
            for j in range(size):
                engine.submit(f"tenant-{j % tenants}",
                              queries[int(wkeys.integers(len(queries)))],
                              key=int(wkeys.integers(1 << 62)))
            engine.drain()
        self.cfg, self.cell, self.device = cfg, cell, device
        self.inputs, self.pool = inputs, queries
        self.tenants = [f"tenant-{t}" for t in range(tenants)]
        self.engine = engine
        self.shapes = dict(rows=index.num_rows, dim=index.dim,
                           kprime=engine.sessions.get("tenant-0").plan.kprime,
                           rlwe=cfg["rlwe"])
        self.fetches = FetchLog(engine.cloud)
        self.cands: Dict[int, np.ndarray] = {}

    # the engine's own methods, read when the harness binds them (after a
    # test's fault), so that the window calls the engine as before, with
    # no frame of this class between
    submit = property(lambda self: self.engine.submit)
    step = property(lambda self: self.engine.step)
    drain = property(lambda self: self.engine.drain)
    pending = property(lambda self: self.engine.pending)

    def on_results(self, results) -> None:
        # one step's results pair in order with its fetch records
        self.cands.update(self.fetches.pair(results))

    def close(self) -> None:
        self.engine.close()
        self.engine = self.fetches = None

    def check(self, run, served, sched, seed: int) -> dict:
        """The numbers compared (see ``reference/check.py``)."""
        cfg, queries = self.cfg, self.pool
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
                cand_ids=self.cands.get(r.request_id), ids=np.asarray(r.ids),
                docs=list(r.docs),
                transcript=None if t is None else dict(
                    request_bytes=t.request_bytes, reply_bytes=t.reply_bytes,
                    fetch_bytes=t.fetch_bytes, docs_bytes=t.docs_bytes,
                    ot_wire_bytes=t.ot_wire_bytes)))
        nums = dict(missing=len(run.due) - len(served),
                    doc_errors=refcheck.document_errors(rows, docs_fmt),
                    wire_errors=refcheck.wire_errors(
                        rows, dim=dim, kprime=plan.kprime, k=k,
                        doc_format=docs_fmt, rlwe=cfg["rlwe"]))
        rng = np.random.default_rng(schedule.sub_seed(seed, 3))
        take = min(self.cell["check_sample"], len(rows))
        sample = [rows[j] for j in sorted(rng.choice(len(rows), take,
                                                     replace=False))]
        if sample:
            corpus = self.inputs["reference_corpus"]()
            pert = refcheck.perturbed(sample, plan.eps, self.device)
            nums.update(refcheck.gaps(corpus, sample, pert, k=k,
                                      kprime=plan.kprime))
            del corpus
        else:
            nums.update(cand_gap=math.inf, topk_gap=math.inf)
        return {name: nums[name] for name in CHECKS}
