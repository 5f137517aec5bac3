#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py [--n-docs N] [--seed S]

At the paper's service config (``repro/configs/remoterag.py``: 10^6
documents of dimension 768, k = 5, the k' = 160 planner knob, the default
RLWE ring) it

  1. builds every CUDA kernel from ``src/repro_torch/csrc`` (one
     extension, ``torch.utils.cpp_extension.load``);
  2. builds the index and its dense NTT-domain candidate cache on the card;
  3. holds each kernel against its plain PyTorch version on the card at the
     path's shapes (integer kernels bit-identical on every prime; score-top-k
     values within 1e-5 relative and ids equal up to scores tied within that
     tolerance), checks the staged re-rank kernel followed by the inverse
     NTT against the fused-iNTT kernel (the staged witness), and times
     kernel (in bursts of back-to-back calls), plain version and, where one
     exists, the PyTorch library call computing the same function; the NTT
     also at one polynomial, the batch's 8 and one request's 41 rows, the
     pointwise product at 1 and 41 rows, the fused re-rank at one request,
     score-top-k at one query and over the row counts of a router slice,
     an IVF cluster and the ingested tail (``at_shapes``); the fused
     re-rank reads gathered rows in place, as the serving path hands them
     over;
  4. serves 8 requests of 4 tenants one at a time through ``run_remoterag``
     and again as one batch (perturb_batch -> topk_batch ->
     encrypted_scores_cached_batch -> decrypt_scores_batch ->
     finish_request), and checks recall@5 = 1.0 against the plaintext
     top-5, decrypted scores against plaintext inner products (2e-3), and
     batched lanes against the one-at-a-time path (ids, docs, wire bytes);
     then splits ``topk_batch``'s wall time (query H2D, kernel, merge, a
     warm repeat) with calls made after the path;
  5. re-views the dense cache as a 16-shard sharded cache (one host-pool
     copy) and checks sharded scores bit-identical to the dense cache's in
     three regimes: stream-only, two pinned shards, async admission;
  6. serves 16 requests of 4 tenants through ``ServeEngine`` three times
     (dense batched, dense sequential, sharded batched with a 4-shard
     device budget) and checks equal ids, documents and wire bytes across
     the runs and recall@5 = 1.0;
  7. serves the same 16 requests through ``ReplicaRouter`` (4 replicas,
     max_batch 8, scatter-gather over 250,000-row slices) on the same index
     and dense cache, and checks every request equal to the dense batched
     engine run (ids, documents, wire bytes, request ids);
  8. frees that state and builds a clustered corpus of 10^6 x 768 (64
     natural clusters) with IVF (16 clusters aligned to 62,500-doc cache
     shards, so clusters and shards coincide) and the sharded cache only,
     then checks (a) 16 aligned ranges, (b) ``cluster_topk`` with every
     cluster equal to the flat scan bit for bit and the flat scan against
     its plain version, (c) 16 requests through an engine at the planned
     nprobe (not exact; first-stage ids equal the plain version's routed
     scan up to ties; recall@5 and rows scanned printed, not gated), (d) a
     50,000-doc ingest on a thread while an engine pinned at epoch 0
     replays its 16 requests bit for bit, the tail shard equal to the plain
     pack, (e) after ``refresh_corpus`` and ``router.replan()``, 8 queries
     near tail docs served with recall@5 = 1.0 and the 4-replica router
     equal to the single engine at epoch 1.

Each path (one-at-a-time, batch, each engine and router run) runs with
the launch counts set to 0 just before it and read just after, and every
kernel of the path must have launched; the kernels line gives each
kernel's launches over the paths, by path and by shape, and launches x
(time - bound) per timed shape.  Every phase prints one JSON line with its
wall time and its device and host memory peaks; the last line is the
device summary.  Any failed check raises, so the script exits non-zero and
prints no result.  It needs a CUDA device and the repository's ``src/``
beside it.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import gc
import math
import os
import resource
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM bytes/s, float32
# outside the tensor cores, and int32 operations (132 SMs x 64 INT32 lanes
# x 1.98 GHz, Hopper white paper).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
INT32_OPS_S = 132 * 64 * 1.98e9

REQUESTS, TENANTS = 8, 4     # requests served per path, tenants (keys)
REPS, PLAIN_REPS = 20, 5     # timed samples per kernel / per plain version
BURST = 20                   # back-to-back kernel calls in one timed sample
# score-top-k kernel vs plain version (float32, two summation orders)
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6
NUM_SHARDS, BUDGET_SHARDS = 16, 4   # sharded cache: shards, engine budget
ROUTER_REPLICAS = 4          # replicas of the router phases
# IVF + ingest phase: corpus rows, clusters (= cache shards of
# IVF_SHARD_DOCS docs), documents ingested
IVF_DOCS, IVF_CLUSTERS, IVF_SHARD_DOCS, INGEST_DOCS = 10**6, 16, 62_500, 50_000
# kernels of the serving path (fused_rerank is the staged witness only)
PATH_KERNELS = ("ntt_fwd", "ntt_inv", "pointwise_mul", "fused_rerank_intt",
                "score_topk")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


_spin_cycles_per_ms: list = []


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if not _spin_cycles_per_ms:
        cycles = 10**7
        torch.cuda._sleep(cycles)           # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        _spin_cycles_per_ms.append(cycles / a.elapsed_time(b))
    return _spin_cycles_per_ms[0]


def time_ms(torch, fn, reps: int, burst: int = 1) -> float:
    """Median device time of one call of ``fn`` over ``reps`` samples.

    A sample is ``burst`` calls back to back between two CUDA events
    enqueued behind a spin kernel longer than the host takes to enqueue
    them, divided by ``burst``: the device runs the launches back to back,
    no host launch gap lies inside the interval, and the events' own
    overhead (~4 us a pair on the H100) is shared by ``burst`` calls.  A
    sample counts only if the device was still spinning when the host had
    enqueued it (its first event not yet reached); one that missed is
    timed again behind a longer spin, and five misses raise, so the result
    is device time or nothing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(burst):
        fn()
    torch.cuda.synchronize()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 1
    times, misses = [], 0
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms(torch)))
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            times.append(a.elapsed_time(b) / burst)
            continue
        misses += 1
        check(misses < 5, "the device reached a timed call before the host "
              "had enqueued it, five times")
        spin_ms *= 4
    return statistics.median(times)


def call_ms(torch, fn, reps: int) -> float:
    """Median time of one call between CUDA events recorded around it:
    device time plus the host's launch gap, what a caller waits."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def int_err(got, want) -> int:
    """max |got - want| over a kernel's integer outputs (tensor or tuple)."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(int((g.long() - w.long()).abs().max()) for g, w in pairs)


def kernel_phase(torch, np, args, index, params, plan, queries) -> list:
    """Each kernel against its plain version at the main path's shapes; the
    inputs each kernel is timed on are the ones its error is read from.
    Kernels are timed in bursts of BURST back-to-back calls (`time_ms`),
    plain versions and library calls one call at a time."""
    from repro_torch.crypto import modring
    from repro_torch.kernels.ntt import fused as kfused
    from repro_torch.kernels.ntt import ntt as kntt
    from repro_torch.kernels.ntt import ref as nref
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.kernels.scoretopk import scoretopk as kscore

    dev = torch.device("cuda")
    gen = np.random.default_rng(args.seed + 7)
    bsz = len(queries)
    n = params.n_poly
    chunks = params.num_chunks(index.dim)
    cpt = params.cands_per_ct(index.dim)
    num_ct = -(-plan.kprime // cpt)
    rows = cpt * chunks
    ctx = params.ctxs[0]
    logn = int(math.log2(n))
    out = []

    def residues(shape, q):
        return torch.from_numpy(gen.integers(0, q, size=shape).astype(
            np.int32)).to(dev)

    def measure(err, kern, plain, nbytes, ops, rate, library=None,
                **extra) -> dict:
        """``kern``/``plain``/``library``: zero-argument callables."""
        b_ms, b_by = bound(nbytes, ops, rate)
        lib_ms = (time_ms(torch, library, PLAIN_REPS)
                  if library is not None else None)
        return dict(max_abs_err=err, ms=time_ms(torch, kern, REPS, BURST),
                    plain_ms=time_ms(torch, plain, PLAIN_REPS),
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    call_ms=call_ms(torch, kern, REPS), **extra)

    def entry(name, source, replaces, measured, *others):
        """One kernel's line: ``measured`` at its main-path shape, then the
        same measurement at the path's other shapes (``at_shapes``)."""
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=0, **measured,
                        **(dict(at_shapes=list(others)) if others else {})))

    def compare(name, kern, plain):
        """Run kernel and plain version once; both must agree bit for bit."""
        err = int_err(kern(), plain())
        check(err == 0, f"{name} disagrees with its plain version by {err}")
        return err

    # NTT forward / inverse at the batched decryption shape (B*num_ct rows),
    # the largest per-request batch, and timed also at one request's
    # decryption (num_ct rows), at the batch's query rows (B, the forward
    # NTT's scoring launches) and at one polynomial (encryption, scoring:
    # most launches); every prime is checked
    batch_rows = bsz * num_ct
    for inverse, name, rep in ((False, "ntt_fwd",
                                "src/repro/kernels/ntt/ntt.py:94"),
                               (True, "ntt_inv",
                                "src/repro/kernels/ntt/ntt.py:94")):
        ref_fn = nref.ntt_inv_ref if inverse else nref.ntt_fwd_ref
        for c in params.ctxs[1:]:
            for shape in ((batch_rows, n), (1, n), (num_ct, n), (4096, n)):
                x = residues(shape, c.q)
                compare(name, lambda: kntt.ntt_cuda(x, c, inverse=inverse),
                        lambda: ref_fn(x, c))
        timed = []
        for polys_n in (1, bsz, num_ct, batch_rows):
            x = residues((polys_n, n), ctx.q)
            err = compare(name, lambda: kntt.ntt_cuda(x, ctx,
                                                      inverse=inverse),
                          lambda: ref_fn(x, ctx))
            # the polynomials in and out and one twiddle table; 3 modular
            # ops a butterfly, and the inverse's N^-1 scaling
            timed.append(measure(
                err, lambda: kntt.ntt_cuda(x, ctx, inverse=inverse),
                lambda: ref_fn(x, ctx), 2 * polys_n * n * 4 + n * 4,
                polys_n * (n // 2) * logn * 3 + (polys_n * n if inverse
                                                 else 0),
                INT32_OPS_S, shape=[polys_n, n]))
        entry(name, "src/repro_torch/csrc/ntt.cu", rep, timed[-1], *timed[:-1])

    # pointwise product at the batched decryption shape, at one request's
    # (num_ct rows) and at one polynomial (encryption)
    timed = []
    for polys_n in (1, num_ct, batch_rows):
        for c in params.ctxs[1:]:
            aa, bb = residues((polys_n, n), c.q), residues((polys_n, n), c.q)
            compare("pointwise_mul",
                    lambda: kntt.pointwise_mul_cuda(aa, bb, c),
                    lambda: nref.pointwise_mul_ref(aa, bb, c))
        a = residues((polys_n, n), ctx.q)
        b = residues((polys_n, n), ctx.q)
        err = compare("pointwise_mul",
                      lambda: kntt.pointwise_mul_cuda(a, b, ctx),
                      lambda: nref.pointwise_mul_ref(a, b, ctx))
        timed.append(measure(
            err, lambda: kntt.pointwise_mul_cuda(a, b, ctx),
            lambda: nref.pointwise_mul_ref(a, b, ctx), 3 * polys_n * n * 4,
            polys_n * n, INT32_OPS_S, shape=[polys_n, n]))
    entry("pointwise_mul", "src/repro_torch/csrc/ntt.cu",
          "src/repro/kernels/ntt/ntt.py:120", timed[-1], *timed[:-1])

    # fused rotate / Hadamard / accumulate / inverse NTT reading the
    # gathered rows (B, k', chunks, P, N) in place, as the path calls it,
    # for the batch and for one request: every prime checked bit for bit,
    # the timed calls cycling through the primes as the path does (the
    # batch's rows, 63 MB, then exceed the L2)
    kprime, nprimes = plan.kprime, params.num_primes
    timed, witness_inputs = [], None
    for b in (1, bsz):
        g = torch.empty((b, kprime, chunks, nprimes, n), dtype=torch.int32,
                        device=dev)
        ins = []
        for i, c in enumerate(params.ctxs):
            g[..., i, :] = residues((b, kprime, chunks, n), c.q)
            tw = residues((cpt, n), c.q)
            ins.append((tw, modring.shoup_quotients(tw, c.q),
                        residues((b, chunks, n), c.q),
                        residues((b, chunks, n), c.q)))
        cycle = itertools.cycle(range(nprimes))

        def kern(i=None, g=g, ins=ins, cycle=cycle):
            i = next(cycle) if i is None else i
            return kfused.fused_rerank_intt_gathered_cuda(
                g, i, kprime, *ins[i], params.ctxs[i])

        def plain(i=0, g=g, ins=ins):
            tw, _, f0, f1 = ins[i]
            return nref.fused_rotate_hadamard_intt_gathered_ref(
                g, i, kprime, tw, f0, f1, params.ctxs[i])

        err = max(compare("fused_rerank_intt", lambda: kern(i),
                          lambda: plain(i)) for i in range(nprimes))
        # the function's inputs (the reference's fused_rerank_intt_pallas
        # reads polys, tw, f0, f1 and ipsi) and its two outputs
        cells = b * num_ct
        nbytes = 4 * (b * kprime * chunks * n + cpt * n
                      + 2 * b * chunks * n + n + 2 * cells * n)
        ops = cells * n * (rows * 5 + 2) + 2 * cells * ((n // 2) * logn * 3
                                                        + n)
        timed.append(measure(
            err, kern, plain, nbytes, ops, INT32_OPS_S,
            shape=[b, num_ct, rows, n]))
        witness_inputs = (g, ins, kern)
    entry("fused_rerank_intt", "src/repro_torch/csrc/fused.cu",
          "src/repro/kernels/ntt/fused.py:132", timed[-1], *timed[:-1])

    # staged re-rank (NTT-domain accumulators out) on the batch's padded
    # rows: bit identical to its plain version, and staged + standalone
    # inverse NTT bit identical to the fused-iNTT kernel (the staged
    # witness), on every prime
    g, ins, kern = witness_inputs
    witness = 0
    for i, c in enumerate(params.ctxs):
        polys = nref.gathered_polys(g, i, kprime, cpt)
        tw, tws, f0, f1 = ins[i]
        err = compare("fused_rerank",
                      lambda: kfused.fused_rerank_cuda(polys, tw, tws, f0,
                                                       f1, c),
                      lambda: nref.fused_rotate_hadamard_ref(polys, tw, f0,
                                                             f1, c))
        staged = kfused.fused_rerank_cuda(polys, tw, tws, f0, f1, c)
        witness = max(witness, int_err(
            tuple(kntt.ntt_cuda(a.reshape(-1, n), c, inverse=True)
                  .reshape(a.shape) for a in staged), kern(i)))
        check(witness == 0, f"staged + inverse NTT differs from the fused "
              f"kernel by {witness}")
    polys = nref.gathered_polys(g, 0, kprime, cpt)
    tw, tws, f0, f1 = ins[0]
    cells = bsz * num_ct
    nbytes = 4 * (polys.numel() + tw.numel() + f0.numel() + f1.numel()
                  + 2 * cells * n)
    entry("fused_rerank", "src/repro_torch/csrc/fused.cu",
          "src/repro/kernels/ntt/fused.py:99", measure(
              err, lambda: kfused.fused_rerank_cuda(polys, tw, tws, f0, f1,
                                                    ctx),
              lambda: nref.fused_rotate_hadamard_ref(polys, tw, f0, f1, ctx),
              nbytes, cells * n * (rows * 5 + 2), INT32_OPS_S,
              shape=[bsz, num_ct, rows, n],
              staged_witness_max_abs_err=witness, on_serving_path=False))

    # score + per-tile top-k over the whole corpus with the batch's queries,
    # and with one query (one request at a time and the sequential engine:
    # most launches); over the row counts of a router slice (250,000), an
    # IVF cluster / cache shard (62,500) and the ingested tail (50,000),
    # the same work as those scans whatever rows they hold
    full_rows = index.num_rows
    timed = []
    for b, sub in ((1, IVF_SHARD_DOCS), (bsz, IVF_SHARD_DOCS),
                   (1, INGEST_DOCS), (bsz, INGEST_DOCS),
                   (bsz, full_rows // ROUTER_REPLICAS), (1, full_rows),
                   (bsz, full_rows)):
        emb = index.embeddings[:min(sub, full_rows)]
        n_rows, dim = emb.shape
        tile, kk = min(2048, n_rows), min(plan.kprime, 2048, n_rows)
        num_tiles = -(-n_rows // tile)
        pad = num_tiles * tile - n_rows
        q = torch.from_numpy(np.asarray(queries[:b], np.float32)).to(dev)
        kv, ki = kscore.score_topk_cuda(q, emb, kk=kk, tile=tile)
        pv, pi = sref.tile_topk_ref(q, emb, kk, tile)
        fin = torch.isfinite(pv)
        check(torch.equal(fin, torch.isfinite(kv)), "score_topk -inf pattern")
        # float32 sums of 768 products in two orders: within SCORE_RTOL of
        # the value plus SCORE_ATOL (a tile shorter than kk, as a router
        # slice's last one, lists scores near 0, where only an absolute
        # bound means anything; the `cuda` tests' tolerance)
        err = (kv[fin] - pv[fin]).abs()
        check(bool((err <= SCORE_RTOL * pv[fin].abs() + SCORE_ATOL).all()),
              f"score_topk values off by {float(err.max())} at "
              f"{[b, n_rows, dim, kk]}")
        mism = (ki != pi) & fin
        if bool(mism.any()):
            # a swapped id must score, under the plain version, within the
            # tolerance of the plain value at that position (a tie)
            t_idx, b_idx, _ = torch.nonzero(mism, as_tuple=True)
            got_ids = ki[mism].long()
            rescored = (q[b_idx].double() * emb[got_ids].double()).sum(-1)
            ok = ((rescored - pv[mism].double()).abs()
                  <= SCORE_RTOL * pv[mism].abs() + SCORE_ATOL)
            check(bool(ok.all()), f"score_topk ids differ beyond score ties "
                                  f"at {[b, n_rows, dim, kk]}")

        def library(q=q, b=b, emb=emb, pad=pad, num_tiles=num_tiles,
                    tile=tile, kk=kk):
            s = torch.nn.functional.pad(torch.matmul(q, emb.T), (0, pad),
                                        value=-torch.inf)
            return torch.topk(s.view(b, num_tiles, tile), kk, dim=-1)

        # the function's work, whatever computes it: each corpus and query
        # byte read once, the lists written once; 2*B*N*n flops and one
        # compare per score
        nbytes = 4 * (n_rows * dim + b * dim + 2 * num_tiles * b * kk)
        ops = 2 * b * n_rows * dim + b * n_rows
        timed.append(measure(
            float(err.max()),
            lambda q=q, emb=emb, kk=kk, tile=tile: kscore.score_topk_cuda(
                q, emb, kk=kk, tile=tile),
            lambda q=q, emb=emb, kk=kk, tile=tile: sref.tile_topk_ref(
                q, emb, kk, tile),
            nbytes, ops, FP32_OPS_S, library=library,
            id_mismatches=int(mism.sum()), shape=[b, n_rows, dim, kk]))
    entry("score_topk", "src/repro_torch/csrc/scoretopk.cu",
          "src/repro/kernels/scoretopk/scoretopk.py:61", timed[-1],
          *timed[:-1])
    return out


def device_busy(torch, prof) -> tuple:
    """({activity name: device ms}, total device ms) from a CUDA-only
    profile; an empty trace gives ({}, None) — the busy and idle numbers
    are then unmeasured (null), never read as an idle device."""
    busy = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = e.name[:60]
            busy[key] = busy.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return busy, (sum(busy.values()) if busy else None)


def serve_phase(torch, np, args, index, cloud, params, plan,
                queries) -> dict:
    from repro_torch.core import protocol
    from repro_torch.kernels import ext
    from repro_torch.serve import batching

    def users():
        return [protocol.RemoteRagUser(
            n=index.dim, N=index.num_rows, k=plan.k, plan=plan,
            rlwe_params=params, rng=np.random.default_rng(args.seed + 100 + t))
            for t in range(TENANTS)]

    def gens():
        return [torch.Generator(device="cuda").manual_seed(args.seed * 1000 + j)
                for j in range(len(queries))]

    nq = len(queries)
    # -- one request at a time through run_remoterag --------------------
    seq_users = users()
    torch.cuda.synchronize()
    ext.reset_launches()
    seq, seq_ms = [], []
    for j, g in enumerate(gens()):
        t0 = time.perf_counter()
        seq.append(protocol.run_remoterag(seq_users[j % TENANTS], cloud,
                                          queries[j], g))
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    seq_launches = ext.launch_counts()
    seq_shapes = shape_counts(ext.launch_shapes())

    # -- the same requests as one batch ----------------------------------
    b_users = users()
    lane_users = [b_users[j % TENANTS] for j in range(nq)]
    stages = {}
    torch.cuda.synchronize()
    ext.reset_launches()

    def stage(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t0) * 1e3
        return r

    # the batch runs under torch.profiler (CUDA activity only) to split its
    # wall time into device-busy time per kernel and idle time
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.__enter__()
    t_batch = time.perf_counter()
    pert = stage("perturb_batch", lambda: batching.perturb_batch(
        gens(), queries, [plan.eps] * nq))
    res = stage("topk_batch", lambda: batching.topk_batch(
        index, pert, plan.kprime))
    enc = stage("encrypt", lambda: [u.encrypt_query(e)
                                    for u, e in zip(lane_users, queries)])
    sc = stage("encrypted_scores_cached_batch",
               lambda: batching.encrypted_scores_cached_batch(
                   params, enc, cloud.candidate_cache, res.indices))
    scores = stage("decrypt_scores_batch", lambda: batching.decrypt_scores_batch(
        [u.sk for u in lane_users], sc))
    cand = res.indices.cpu().numpy()

    def finish():
        outs = []
        for j, u in enumerate(lane_users):
            req = protocol.Request(perturbed=pert[j], kprime=plan.kprime,
                                   enc_query=enc[j], backend="rlwe")
            reply = protocol.Reply(candidate_ids=cand[j],
                                   enc_scores=sc.lane(j))
            outs.append(protocol.finish_request(
                u, cloud, req, reply,
                u.positions_from_scores(scores[j], plan.kprime)))
        return outs

    batch = stage("finish_request", finish)
    batch_wall_ms = (time.perf_counter() - t_batch) * 1e3
    prof.__exit__(None, None, None)
    batch_launches = ext.launch_counts()
    batch_shapes = shape_counts(ext.launch_shapes())
    busy, busy_ms = device_busy(torch, prof)
    topk_split = topk_batch_split(torch, index, pert, plan.kprime)
    topk_split["first_ms"] = stages["topk_batch"]

    # -- checks -------------------------------------------------------
    q = torch.from_numpy(np.asarray(queries, np.float32)).cuda()
    plain = torch.matmul(q, index.embeddings.T)           # TF32 is off
    top, order = torch.sort(-plain, dim=1, stable=True)
    want = order[:, :plan.k].cpu().numpy()
    # plaintext gap between the k-th and (k+1)-th best rows: a gap below
    # the scheme's 2^-13 fixed-point error can swap them (in the JAX
    # reference too, whose ciphertexts are bit-identical)
    gaps = (top[:, plan.k] - top[:, plan.k - 1]).cpu().tolist()
    recalls, max_err = [], 0.0
    for j in range(nq):
        docs_s, ids_s, tr_s = seq[j]
        docs_b, ids_b, tr_b = batch[j]
        check(np.array_equal(ids_s, ids_b) and docs_s == docs_b
              and tr_s.total_bytes == tr_b.total_bytes,
              f"request {j}: batched lane differs from one-at-a-time path")
        check(docs_s == [f"passage-{int(i)}".encode() for i in ids_s],
              f"request {j}: documents do not match ids")
        recalls.append(len(set(ids_s.tolist()) & set(want[j].tolist()))
                       / plan.k)
        truth = (index.rows(cand[j]).double() @ q[j].double()).cpu().numpy()
        max_err = max(max_err, float(np.abs(scores[j] - truth).max()))
    check(all(r == 1.0 for r in recalls),
          f"recall@{plan.k} {recalls}; k-th/(k+1)-th plaintext gaps {gaps}")
    check(max_err <= 2e-3, f"decrypted scores off by {max_err}")
    shared = dict(cand=cand, enc=enc, want=want)
    return shared, dict(requests=nq, tenants=TENANTS, recall_at_k=recalls,
                kth_gap=gaps,
                max_score_err=max_err, seq_request_ms=seq_ms,
                batch_stage_ms=stages,
                batch_total_ms=sum(stages.values()),
                batch_wall_ms=batch_wall_ms, batch_device_busy_ms=busy_ms,
                batch_device_idle_share=(None if busy_ms is None
                                         else 1.0 - busy_ms / batch_wall_ms),
                batch_device_ms_by_kernel=dict(sorted(
                    busy.items(), key=lambda kv: -kv[1])[:12]),
                topk_batch_split=topk_split,
                total_bytes=[b[2].total_bytes for b in batch],
                launches_seq=seq_launches, launches_batch=batch_launches,
                shapes_seq=seq_shapes, shapes_batch=batch_shapes)


def topk_batch_split(torch, index, pert, kprime: int) -> dict:
    """Wall ms of ``topk_batch``'s parts, each called again after the
    batch's run (so their launches are not the path's): the queries' H2D
    copy, the kernel, the cross-tile merge (a stable sort of the
    (B, num_tiles * kk) candidates), then the whole stage again, warm."""
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.kernels.scoretopk import scoretopk as kscore
    from repro_torch.serve import batching

    emb = index.embeddings
    tile = min(2048, emb.shape[0])
    kk = min(kprime, tile)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    q, h2d = wall(lambda: torch.as_tensor(pert, dtype=torch.float32,
                                          device=emb.device))
    (vals, ids), kern = wall(lambda: kscore.score_topk_cuda(q, emb, kk=kk,
                                                            tile=tile))
    _, merge = wall(lambda: sref.merge_tiles_ref(vals, ids, kprime))
    _, warm = wall(lambda: batching.topk_batch(index, pert, kprime))
    return dict(h2d_ms=h2d, kernel_ms=kern, merge_ms=merge, warm_ms=warm)


def shape_counts(counts: dict) -> list:
    """`ext.launch_shapes()` as JSON: [[kernel, shape, launches], ...]."""
    return [[k[0], list(k[1]), v] for k, v in sorted(counts.items())]


def shape_key(shape) -> str:
    return "x".join(str(d) for d in shape)


def launch_tally(kernels: list, paths: list) -> None:
    """Each kernel's launches over the paths' runs (``paths``: [(name,
    launches, shapes)]), in all, by path and by shape; each timed row's
    launches at its own shape and launches x (time - bound)
    (``excess_ms``), the rule-2 ranking of the kernels."""
    for kern in kernels:
        by_path = {name: counts.get(kern["name"], 0)
                   for name, counts, _ in paths}
        kern["launches"] = sum(by_path.values())
        kern["launches_by_path"] = by_path
        by_shape = collections.Counter()
        for _, _, shapes in paths:
            for name, shape, count in shapes:
                if name == kern["name"]:
                    by_shape[shape_key(shape)] += count
        kern["launches_by_shape"] = dict(by_shape)
        for row in [kern] + kern.get("at_shapes", []):
            row["launches_at_shape"] = by_shape.get(shape_key(row["shape"]),
                                                    0)
            row["excess_ms"] = row["launches_at_shape"] * (
                row["ms"] - row["bound_ms"])


def path_launches(name: str, counts: dict) -> dict:
    """Fail unless every kernel of the serving path launched in ``counts``
    (one path's run, counts set to 0 just before it)."""
    for kern in PATH_KERNELS:
        check(counts.get(kern, 0) > 0, f"{name}: kernel {kern} not launched")
    return counts


def cache_phase(torch, np, args, cache, params, plan, shared) -> dict:
    """The dense cache re-viewed as a 16-shard sharded cache (one copy of
    the pool to the host); sharded scores must equal the dense cache's bit
    for bit in three regimes."""
    from repro_torch.crypto import rlwe

    cand, enc = shared["cand"].astype(np.int64), shared["enc"]
    gen = np.random.default_rng(args.seed + 11)
    t0 = time.perf_counter()
    pool = cache.host_pool()
    host_copy_s = time.perf_counter() - t0
    out = dict(host_pool_copy_s=host_copy_s, host_pool_gb=pool.nbytes / 1e9,
               host_pool_gb_s=pool.nbytes / 1e9 / host_copy_s)

    def same_as_dense(sh, ids, label):
        want = rlwe.encrypted_scores_cached_batch(params, enc, cache, ids)
        got = rlwe.encrypted_scores_cached_batch(params, enc, sh, ids)
        check(torch.equal(got.c0, want.c0) and torch.equal(got.c1, want.c1),
              f"cache phase ({label}): sharded scores differ from dense")

    def gather_ms(sh, ids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.gather(ids)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def config(**kw):
        return rlwe.CandidateCacheConfig(num_shards=NUM_SHARDS, **kw)

    # (a) stream-only, on the 8 requests' top-k' ids: host row gathers
    sh = rlwe.shard_candidate_cache(cache, config(max_resident_bytes=0))
    check(sh.num_shards == NUM_SHARDS, f"{sh.num_shards} shards")
    same_as_dense(sh, cand, "stream-only")
    out["stream_only"] = dict(
        gather_ms=[gather_ms(sh, cand) for _ in range(3)],
        gather_mb=cand.size * pool[0].nbytes / 1e6, stats=sh.stats())
    sh.close()
    shard_docs = sh.shard_docs

    # (b) two pinned shards, ids confined to them: device-side gathers
    sh = rlwe.shard_candidate_cache(cache, config(pin_on_access=False))
    t0 = time.perf_counter()
    sh.pin(0)
    sh.pin(1)
    pin_s = time.perf_counter() - t0
    ids = gen.integers(0, 2 * shard_docs, size=cand.shape)
    same_as_dense(sh, ids, "pinned")
    check(sh.resident_shards == (0, 1) and sh.misses == 0,
          f"pinned: resident {sh.resident_shards}, misses {sh.misses}")
    out["pinned"] = dict(pin_two_shards_s=pin_s,
                         gather_ms=[gather_ms(sh, ids) for _ in range(3)],
                         stats=sh.stats())
    sh.close()
    del sh

    # (c) async admission on first touch: stream, admit on the admitter's
    # stream, then gather device-side; the bits never change
    sh = rlwe.shard_candidate_cache(cache, config(admit_threshold=1))
    ids = gen.integers(5 * shard_docs, 6 * shard_docs, size=cand.shape)
    first_ms = gather_ms(sh, ids)          # miss: streams, enqueues shard 5
    same_as_dense(sh, ids, "async, admission in flight or done")
    t0 = time.perf_counter()
    sh.flush()
    flush_s = time.perf_counter() - t0
    check(sh.resident_shards == (5,) and sh.async_admissions == 1,
          f"async: resident {sh.resident_shards}, "
          f"admissions {sh.async_admissions}")
    same_as_dense(sh, ids, "async, resident")
    out["async"] = dict(first_gather_ms=first_ms, flush_s=flush_s,
                        gather_ms=[gather_ms(sh, ids) for _ in range(3)],
                        stats=sh.stats())
    sh.close()
    del sh
    torch.cuda.synchronize()
    return out


def engine_phase(torch, np, args, index, params, plan, queries,
                 shared) -> dict:
    """16 requests of 4 tenants (the 8 queries, twice) through ServeEngine:
    dense batched, dense sequential, sharded batched.  Every request must
    return the same ids, documents and wire bytes in all three runs, with
    recall@5 = 1.0."""
    from repro_torch.crypto import rlwe
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager

    shard_bytes = -(-index.num_rows // NUM_SHARDS) * params.num_chunks(
        index.dim) * params.num_primes * params.n_poly * 4
    runs = {
        "dense_batched": EngineConfig(max_batch=8, trace=True),
        "dense_sequential": EngineConfig(max_batch=1, sequential=True,
                                         trace=True),
        "sharded_batched": EngineConfig(
            max_batch=8, trace=True, cache_config=rlwe.CandidateCacheConfig(
                num_shards=NUM_SHARDS,
                max_resident_bytes=BUDGET_SHARDS * shard_bytes)),
    }
    want = shared["want"]
    n = 2 * len(queries)
    reqs = [queries[j % len(queries)] for j in range(n)]
    keys = [args.seed * 1000 + j for j in range(n)]
    out, results = {}, {}
    for name, cfg in runs.items():
        engine = ServeEngine(index, config=cfg, sessions=SessionManager(
            rlwe_params=params, deterministic_seeds=True))
        for t in range(TENANTS):
            engine.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                                k=plan.k, plan_kwargs={"kprime": 160})
        # batched runs under torch.profiler for the device's busy and idle
        # share of the run's wall time
        res, run = serve_run(torch, np, engine, reqs, keys,
                             lambda j: f"tenant-{j % TENANTS}",
                             f"engine {name}", profiled=not cfg.sequential)
        engine.close()
        recalls = [len(set(r.ids.tolist()) & set(
            want[r.request_id % len(queries)].tolist())) / plan.k
            for r in res]
        check(all(x == 1.0 for x in recalls),
              f"engine {name}: recall@{plan.k} {recalls}")
        results[name] = res
        summary = engine.metrics.summary()
        agg = summary["aggregate"]
        out[name] = dict(
            run, num_batches=summary["num_batches"],
            p50_latency_s=agg["p50_latency_s"],
            p99_latency_s=agg["p99_latency_s"],
            mean_latency_s=agg["mean_latency_s"],
            stages=engine.trace_summary()["stages"],
            cache_stats=engine.cache_stats())
    base = results["dense_batched"]
    for name, res in results.items():
        for a, b in zip(base, res):
            check(same_result(a, b), f"engine {name}: request "
                                     f"{b.request_id} differs from the "
                                     f"dense batched run")
    return out, base


class Peaks:
    """Peak device memory (PyTorch's allocator, reset on entry) and peak
    host RSS (``/proc/self/statm`` sampled every 20 ms) over one phase."""

    def __init__(self, torch):
        self.torch = torch
        self.result: dict = {}

    @staticmethod
    def rss_gb() -> float:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e9

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            self._host = max(self._host, self.rss_gb())

    def __enter__(self) -> "Peaks":
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self._host = self.rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.torch.cuda.synchronize()
        self._stop.set()
        self._thread.join()
        self.result = dict(
            device_peak_gb=self.torch.cuda.max_memory_allocated() / 1e9,
            device_now_gb=self.torch.cuda.memory_allocated() / 1e9,
            host_peak_gb=max(self._host, self.rss_gb()),
            host_now_gb=self.rss_gb())


def same_result(a, b) -> bool:
    """Two ServeResults agree: request id, tenant, ids, documents, bytes."""
    return (a.request_id == b.request_id and a.tenant == b.tenant
            and a.ids.tolist() == b.ids.tolist() and a.docs == b.docs
            and all(getattr(a.transcript, f) == getattr(b.transcript, f)
                    for f in ("total_bytes", "request_bytes",
                              "reply_bytes")))


def close(got, want) -> bool:
    """Score-top-k values of kernel and plain version agree."""
    return bool(((got - want).abs()
                 <= SCORE_RTOL * want.abs() + SCORE_ATOL).all())


def ids_up_to_ties(torch, q, emb, got, want, want_vals, what) -> int:
    """``got``/``want``: (B, k) ids over rows ``emb`` for queries ``q``;
    where they differ, the id ``got`` holds must score (float64) within
    the tolerance of the value ``want`` has there: kernel and plain version
    sum in other orders, so rows tied that closely may swap.  Returns the number
    of swapped positions."""
    mism = got != want
    if bool(mism.any()):
        b_idx, _ = torch.nonzero(mism, as_tuple=True)
        rescored = (q[b_idx].double() * emb[got[mism].long()].double()).sum(-1)
        ok = ((rescored - want_vals[mism].double()).abs()
              <= SCORE_RTOL * want_vals[mism].abs() + SCORE_ATOL)
        check(bool(ok.all()), f"{what}: ids differ beyond score ties")
    return int(mism.sum())


def serve_run(torch, np, srv, queries, keys, tenant, name,
              profiled=False, join=None) -> tuple:
    """Submit ``queries[j]`` with ``keys[j]`` for ``tenant(j)`` and drain,
    the launch counts set to 0 just before and read just after (with
    ``profiled``, under torch.profiler, CUDA activity only; ``join`` is
    called after the drain, before the counts are read, for work that runs
    beside the requests).  Every kernel of the serving path must have
    launched and every request succeeded."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ext

    torch.cuda.synchronize()
    ext.reset_launches()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    for j, (q, key) in enumerate(zip(queries, keys)):
        srv.submit(tenant(j), q, key=key)
    res = srv.drain()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    if join is not None:
        join()
    busy_ms = None
    if prof is not None:
        prof.__exit__(None, None, None)
        _, busy_ms = device_busy(torch, prof)
    launches = path_launches(name, ext.launch_counts())
    check(len(res) == len(queries) and all(r.ok for r in res),
          f"{name}: {[r.error for r in res if not r.ok]}")
    return res, dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                     device_idle_share=(None if busy_ms is None
                                        else 1.0 - busy_ms / wall_ms),
                     launches=launches,
                     shapes=shape_counts(ext.launch_shapes()))


def router_phase(torch, np, args, index, params, plan, queries,
                 want) -> dict:
    """The engine phase's 16 requests through ReplicaRouter(4 replicas,
    max_batch 8) over the same index and dense cache: per request equal to
    the dense batched engine run (ids, documents, wire bytes, request
    ids)."""
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   SessionManager)

    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=ROUTER_REPLICAS,
        engine=EngineConfig(max_batch=8, trace=True)),
        sessions=SessionManager(rlwe_params=params, deterministic_seeds=True))
    for t in range(TENANTS):
        rt.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                        k=plan.k, plan_kwargs={"kprime": 160})
    n = 2 * len(queries)
    res, run = serve_run(
        torch, np, rt, [queries[j % len(queries)] for j in range(n)],
        [args.seed * 1000 + j for j in range(n)],
        lambda j: f"tenant-{j % TENANTS}", "router", profiled=True)
    summary = rt.summary()
    stages = {str(h.replica_id): h.engine.trace_summary()["stages"]
              for h in rt.replicas}
    rt.close()
    by_rid = {r.request_id: r for r in want}
    check(sorted(by_rid) == [r.request_id for r in res],
          "router: request ids differ from the engine run's")
    for r in res:
        check(same_result(by_rid[r.request_id], r),
              f"router: request {r.request_id} differs from the dense "
              f"batched engine run")
    fleet = summary["router"]
    check(fleet["fallback_scans"] == 0 and not fleet["quarantines"],
          f"router: {fleet}")
    return dict(replicas=ROUTER_REPLICAS, slices=summary["slices"],
                scatter_calls=fleet["scatter_calls"],
                slice_scans=fleet["slice_scans"],
                merged_candidates=fleet["merged_candidates"],
                merge_wall_s=fleet["merge_wall_s"],
                merge_wall_ms_per_scatter=(
                    fleet["merge_wall_s"] * 1e3 / fleet["scatter_calls"]),
                submitted=fleet["submitted"], stages_by_replica=stages,
                **run)


def plain_routed_topk(torch, np, view, q, k, nprobe) -> tuple:
    """The IVF first stage through the plain version on the card: each
    query's routed clusters' rows gathered and scanned by
    `tile_topk_ref`'s scoring (`topk_ref`), global ids."""
    from repro_torch.kernels.scoretopk import ref as sref

    cm = view.cluster_map
    routed = cm.route(q.cpu().numpy(), nprobe)
    vals, ids = [], []
    for b in range(q.shape[0]):
        rows = torch.cat([torch.arange(int(cm.starts[c]), int(cm.stops[c]),
                                       device=q.device)
                          for c in sorted(int(c) for c in routed[b])])
        v, pos = sref.topk_ref(q[b:b + 1], view.embeddings[rows], k)
        vals.append(v[0])
        ids.append(rows[pos[0].long()].to(torch.int32))
    return torch.stack(vals), torch.stack(ids), routed


def ivf_phase(torch, np, args, params) -> tuple:
    """The epoch-versioned corpus at 10^6 x 768: a clustered corpus (64
    natural clusters) built with IVF (16 clusters aligned to 62,500-doc
    cache shards), the sharded cache only; the flat and routed first
    stages, an engine at the planned nprobe, a 50,000-doc ingest on a
    thread under an epoch-0 replay, then refresh and replan over the grown
    corpus.  Returns (phase dict, [(path, launches, shapes)])."""
    from repro_torch.core import planner
    from repro_torch.crypto import rlwe
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.kernels.ntt import ref as nref
    from repro_torch.kernels.scoretopk import ref as sref
    from repro_torch.retrieval import index as index_mod
    from repro_torch.retrieval.index import FlatIndex, IvfConfig
    from repro_torch.retrieval.topk import (cluster_topk, distributed_topk,
                                            plan_nprobe)
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   ServeEngine, SessionManager, batching)

    dim, n_docs = 768, IVF_DOCS
    out, paths = {}, []
    t0 = time.perf_counter()
    corpus = synth.clustered_corpus(np.random.default_rng(args.seed), n_docs,
                                    dim, n_clusters=64)
    queries = synth.queries_near_corpus(np.random.default_rng(args.seed + 1),
                                        corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(n_docs)]
    out["data_s"] = time.perf_counter() - t0

    # the k-means inside FlatIndex.build, timed on its own
    kmeans, timing = index_mod._kmeans_cluster_map, {}

    def timed_kmeans(emb, cfg):
        t = time.perf_counter()
        r = kmeans(emb, cfg)
        timing["kmeans_s"] = time.perf_counter() - t
        return r

    index_mod._kmeans_cluster_map = timed_kmeans
    try:
        t0 = time.perf_counter()
        index = FlatIndex.build(corpus, documents=docs, ivf=IvfConfig(
            num_clusters=IVF_CLUSTERS, align=IVF_SHARD_DOCS))
        torch.cuda.synchronize()
        out["index_build_s"] = time.perf_counter() - t0
    finally:
        index_mod._kmeans_cluster_map = kmeans
    out["kmeans_s"] = timing["kmeans_s"]
    del corpus, docs
    cm = index.cluster_map
    # (a) 16 aligned, contiguous ranges
    check(cm.num_clusters == IVF_CLUSTERS
          and all(int(a) % IVF_SHARD_DOCS == 0 for a in cm.starts)
          and np.array_equal(cm.starts[1:], cm.stops[:-1])
          and int(cm.stops[-1]) == n_docs,
          f"ivf: cluster map {cm.starts.tolist()} {cm.stops.tolist()}")
    plan = planner.plan(n=dim, N=n_docs, k=5, kprime=160)
    nprobe = plan_nprobe(cm, plan.kprime)
    shard_bytes = IVF_SHARD_DOCS * params.num_chunks(dim) * \
        params.num_primes * params.n_poly * 4
    cfg = rlwe.CandidateCacheConfig(
        shard_docs=IVF_SHARD_DOCS,
        max_resident_bytes=BUDGET_SHARDS * shard_bytes)
    torch.cuda.synchronize()
    ext.reset_launches()
    t0 = time.perf_counter()
    cache = index.candidate_cache(params, cfg)
    torch.cuda.synchronize()
    out["pack_s"] = time.perf_counter() - t0
    paths.append(("ivf_pack", ext.launch_counts(),
                  shape_counts(ext.launch_shapes())))
    check(cache.num_shards == IVF_CLUSTERS
          and cache._starts.tolist() == cm.starts.tolist(),
          "ivf: cache shards and clusters do not coincide")

    # (b) every cluster scanned == the flat scan, bit for bit
    q = torch.from_numpy(queries).cuda()
    view = index.corpus_view()
    flat = distributed_topk(index, q, plan.kprime)
    routed = cluster_topk(view, q, plan.kprime)
    check(torch.equal(routed.indices, flat.indices)
          and torch.equal(routed.values.view(torch.int32),
                          flat.values.view(torch.int32))
          and routed.exact and flat.exact,
          "ivf: cluster_topk(nprobe=None) differs from the flat scan")
    pv, pi = sref.topk_ref(q, index.embeddings, plan.kprime)
    err = float((flat.values - pv).abs().max())
    check(close(flat.values, pv), f"ivf: flat scan values off the plain "
                                  f"version by {err}")
    out["flat_vs_plain"] = dict(max_abs_err=err, id_swaps=ids_up_to_ties(
        torch, q, index.embeddings, flat.indices, pi.to(flat.indices.dtype),
        pv, "ivf flat scan"))

    def sessions():
        return SessionManager(rlwe_params=params, deterministic_seeds=True)

    def engine(nprobe_=None):
        eng = ServeEngine(index, config=EngineConfig(
            max_batch=8, trace=True, cache_config=cfg, nprobe=nprobe_),
            sessions=sessions())
        for t in range(TENANTS):
            eng.open_session(f"tenant-{t}", n=dim, N=n_docs, k=plan.k,
                             plan_kwargs={"kprime": 160})
        return eng

    n_req = 2 * len(queries)
    reqs = [queries[j % len(queries)] for j in range(n_req)]
    keys = [args.seed * 1000 + j for j in range(n_req)]

    def tenant(j):
        return f"tenant-{j % TENANTS}"

    # truth for recall: the plaintext top-5 over the corpus
    scores = torch.matmul(q, index.embeddings.T)        # TF32 is off
    top5 = torch.sort(-scores, dim=1, stable=True)[1][:, :plan.k].cpu()

    def recall(res):
        return [len(set(r.ids.tolist()) & set(top5[r.request_id % len(
            queries)].tolist())) / plan.k for r in res]

    # (c) routed engine at the planned nprobe
    routed_eng = engine(nprobe)
    res_c, run = serve_run(torch, np, routed_eng, reqs, keys, tenant,
                           "ivf_routed_engine", profiled=True)
    paths.append(("ivf_routed_engine", run["launches"], run["shapes"]))
    out["routed_engine"] = dict(run, nprobe=nprobe, recall_at_k=recall(res_c),
                                stages=routed_eng.trace_summary()["stages"],
                                cache_stats=routed_eng.cache_stats())
    routed_eng.close()
    # its first stage again, on the engine's own perturbations (a lane is
    # perturb(generator(key)) whatever the batch): not exact, and the ids
    # the plain version's routed scan gives
    pert = batching.perturb_batch(
        [torch.Generator(device="cuda").manual_seed(k) for k in keys],
        np.stack(reqs), [plan.eps] * n_req)
    first = cluster_topk(view, pert, plan.kprime, nprobe=nprobe)
    check(not first.exact, "ivf: a routed scan at nprobe < C reported exact")
    rv, ri, lanes = plain_routed_topk(torch, np, view, pert, plan.kprime,
                                      nprobe)
    err = float((first.values - rv).abs().max())
    check(close(first.values, rv), f"ivf: routed values off the plain "
                                   f"version by {err}")
    swaps = ids_up_to_ties(torch, pert, index.embeddings, first.indices,
                           ri, rv, "ivf routed scan")
    cand = first.indices.cpu().numpy()
    for r in res_c:
        check(set(r.ids.tolist()) <= set(cand[r.request_id].tolist()),
              f"ivf: request {r.request_id} served ids outside its "
              f"routed candidates")
    out["routed_engine"].update(
        first_stage_max_abs_err=err, first_stage_id_swaps=swaps,
        rows_scanned_per_query=cm.sizes[lanes].sum(axis=1).tolist())

    # (d) the flat engine's results at epoch 0, then the same requests
    # through a fresh engine pinned at epoch 0 while 50,000 docs are
    # ingested on a thread; a router over the same index, made now, is
    # replanned after the ingest
    flat_eng = engine()
    res_d0, run = serve_run(torch, np, flat_eng, reqs, keys, tenant,
                            "ivf_flat_engine", profiled=True)
    paths.append(("ivf_flat_engine", run["launches"], run["shapes"]))
    out["flat_engine"] = dict(run, recall_at_k=recall(res_d0),
                              stages=flat_eng.trace_summary()["stages"])
    flat_eng.close()
    # every cluster, routed: bit-identical to the flat engine at epoch 0,
    # and after the refresh it scans the tail cluster too
    pinned = engine(IVF_CLUSTERS + 1)
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=ROUTER_REPLICAS,
        engine=EngineConfig(max_batch=8, cache_config=cfg)),
        sessions=sessions())
    tail = synth.clustered_corpus(np.random.default_rng(args.seed + 2),
                                  INGEST_DOCS, dim, n_clusters=64)
    tail_docs = [f"ingested-{i}".encode() for i in range(INGEST_DOCS)]
    box = {}

    def writer():
        try:
            box["t0"] = time.perf_counter()
            box["view"] = index.ingest(tail, documents=tail_docs)
            torch.cuda.synchronize()
            box["t1"] = time.perf_counter()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["error"] = e

    torch.cuda.synchronize()
    ext.reset_launches()
    t_replay = time.perf_counter()
    th = threading.Thread(target=writer, name="ingest")
    th.start()
    t_serve = time.perf_counter()
    res_d, run = serve_run(torch, np, pinned, reqs, keys, tenant,
                           "ivf_replay_under_ingest", join=th.join)
    if "error" in box:
        raise box["error"]
    paths.append(("ivf_replay_under_ingest", run["launches"],
                  run["shapes"]))
    for a, b in zip(res_d0, res_d):
        check(same_result(a, b), f"ivf: epoch-0 replay of request "
                                 f"{b.request_id} differs under ingest")
    # the ingest packs its docs in blocks (`_pack_corpus_ntt`): forward NTTs
    # of block * chunks rows and of the remainder's, shapes no request has
    chunks = params.num_chunks(dim)
    block = max(1, (1 << 24) // (chunks * params.n_poly))
    pack_rows = {min(block, INGEST_DOCS) * chunks,
                 (INGEST_DOCS % block or block) * chunks}
    ingest_ntt = sum(c for name, shape, c in run["shapes"]
                     if name == "ntt_fwd" and shape[0] in pack_rows)
    check(ingest_ntt == params.num_primes * -(-INGEST_DOCS // block),
          f"ivf: the ingest's pack launched {ingest_ntt} forward NTTs")
    view1 = box["view"]
    check(view1.epoch == 1 and view1.num_rows == n_docs + INGEST_DOCS
          and cache.num_shards == IVF_CLUSTERS + 1 and cache.epoch == 1,
          "ivf: ingest did not publish epoch 1 and its tail shard")
    new_rows = index.embeddings[n_docs:]
    plain_tail = rlwe._pack_corpus_ntt(params, new_rows, host=True,
                                       ntt_fwd=nref.ntt_fwd_ref)
    check(np.array_equal(cache.shards[-1], plain_tail),
          "ivf: the tail shard differs from the plain pack")
    del plain_tail
    out["ingest"] = dict(
        docs=INGEST_DOCS, ingest_s=box["t1"] - box["t0"],
        ingest_start_s=box["t0"] - t_replay, ingest_end_s=box["t1"] - t_replay,
        replay_end_s=t_serve - t_replay + run["wall_ms"] / 1e3, replay=run,
        ingest_ntt_fwd_launches=ingest_ntt,
        cache_stats=cache.stats())

    # (e) refresh and replan; 8 queries near tail docs
    pinned.refresh_corpus()
    spans = rt.replan()
    grown = n_docs + INGEST_DOCS
    q_tail = synth.queries_near_corpus(np.random.default_rng(args.seed + 3),
                                       new_rows.cpu().numpy(), REQUESTS,
                                       jitter=0.02)
    qt = torch.from_numpy(q_tail).cuda()
    sc = torch.matmul(qt, index.embeddings.T)
    order = torch.sort(-sc, dim=1, stable=True)
    want5 = order[1][:, :plan.k].cpu()
    gaps = (order[0][:, plan.k] - order[0][:, plan.k - 1]).cpu().tolist()
    check(bool((want5[:, 0] >= n_docs).all()),
          "ivf: a query near a tail doc has a best match outside the tail")
    grown_runs = {}
    for name, srv in (("ivf_grown_engine", pinned), ("ivf_grown_router", rt)):
        for t in range(TENANTS):
            srv.open_session(f"tenant-{t}@e1", n=dim, N=grown, k=plan.k,
                             plan_kwargs={"kprime": 160})
        res, run = serve_run(torch, np, srv, list(q_tail),
                             [args.seed * 1000 + 500 + j
                              for j in range(REQUESTS)],
                             lambda j: f"tenant-{j % TENANTS}@e1", name)
        paths.append((name, run["launches"], run["shapes"]))
        rec = [len(set(r.ids.tolist()) & set(want5[r.request_id - res[0]
               .request_id].tolist())) / plan.k for r in res]
        check(all(x == 1.0 for x in rec),
              f"{name}: recall@{plan.k} {rec}; k-th/(k+1)-th gaps {gaps}")
        grown_runs[name] = (res, dict(run, recall_at_k=rec))
    pinned.close()
    rsum = rt.summary()["router"]
    rt.close()
    (res_e, run_e), (res_r, run_r) = grown_runs["ivf_grown_engine"], \
        grown_runs["ivf_grown_router"]
    for a, b in zip(res_e, res_r):
        check(a.tenant == b.tenant and a.ids.tolist() == b.ids.tolist()
              and a.docs == b.docs
              and a.transcript.total_bytes == b.transcript.total_bytes,
              f"ivf: router request {b.request_id} differs from the single "
              f"engine at epoch 1")
    out["grown"] = dict(spans=spans, kth_gap=gaps, engine=run_e,
                        router=dict(run_r, merge_wall_s=rsum["merge_wall_s"],
                                    scatter_calls=rsum["scatter_calls"]))
    del index, cache, view, view1, new_rows
    return out, paths


def flat_phases(torch, np, args, emits) -> tuple:
    """Phases 2-7 on the paper config's uniform corpus, in one scope so the
    index, its dense cache and the cache's host pool are freed when it
    returns.  Appends the phases' JSON lines to ``emits``; returns (kernel
    rows, [(path, launches, shapes)])."""
    from repro_torch.core import planner, protocol
    from repro_torch.crypto import rlwe
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.retrieval.index import FlatIndex

    # -- data, index, cache (paper config: repro/configs/remoterag.py) ------
    dim, k, kprime_knob = 768, 5, 160
    params = rlwe.RlweParams()
    t0 = time.perf_counter()
    corpus = synth.uniform_corpus(np.random.default_rng(args.seed),
                                  args.n_docs, dim)
    queries = synth.queries_near_corpus(np.random.default_rng(args.seed + 1),
                                        corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(args.n_docs)]
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = FlatIndex.build(corpus, documents=docs)
    del corpus
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    plan = planner.plan(n=dim, N=args.n_docs, k=k, kprime=kprime_knob)
    cloud = protocol.RemoteRagCloud(index, rlwe_params=params)
    torch.cuda.reset_peak_memory_stats()
    ext.reset_launches()
    t0 = time.perf_counter()
    cache = cloud.candidate_cache
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    cache_launches = ext.launch_counts()

    with Peaks(torch) as pk_serve:
        t0 = time.perf_counter()
        kernels = kernel_phase(torch, np, args, index, params, plan, queries)
        kernels_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        shared, serve = serve_phase(torch, np, args, index, cloud, params,
                                    plan, queries)
        serve_s = time.perf_counter() - t0
    for path in ("launches_seq", "launches_batch"):
        path_launches(path, serve[path])
    with Peaks(torch) as pk_cache:
        t0 = time.perf_counter()
        cache_out = cache_phase(torch, np, args, cache, params, plan, shared)
        cache_phase_s = time.perf_counter() - t0
    with Peaks(torch) as pk_engine:
        t0 = time.perf_counter()
        engine, dense_results = engine_phase(torch, np, args, index, params,
                                             plan, queries, shared)
        engine_s = time.perf_counter() - t0
    with Peaks(torch) as pk_router:
        t0 = time.perf_counter()
        router = router_phase(torch, np, args, index, params, plan, queries,
                              dense_results)
        router_s = time.perf_counter() - t0
    paths = [("serve_seq", serve["launches_seq"], serve["shapes_seq"]),
             ("serve_batch", serve["launches_batch"], serve["shapes_batch"])]
    paths += [(f"engine_{name}", run["launches"], run["shapes"])
              for name, run in engine.items()]
    paths.append(("router", router["launches"], router["shapes"]))
    emits.append({"phase": "serve", "n_docs": args.n_docs, "dim": dim,
                  "k": plan.k, "kprime": plan.kprime, "path": plan.path,
                  "eps": plan.eps, "data_s": data_s, "index_s": index_s,
                  "cache_build_s": cache_s, "cache_gb": cache.nbytes / 1e9,
                  "cache_launches": cache_launches,
                  "kernels_phase_s": kernels_s, "phase_s": serve_s,
                  "memory": pk_serve.result, **serve})
    emits.append({"phase": "cache", "num_shards": NUM_SHARDS,
                  "phase_s": cache_phase_s, "memory": pk_cache.result,
                  **cache_out})
    emits.append({"phase": "engine", "requests": 2 * len(queries),
                  "tenants": TENANTS, "budget_shards": BUDGET_SHARDS,
                  "phase_s": engine_s, "runs": engine,
                  "memory": pk_engine.result})
    emits.append({"phase": "router", "requests": 2 * len(queries),
                  "phase_s": router_s, "memory": pk_router.result, **router})
    for run in engine.values():
        run.pop("shapes")
    router.pop("shapes")
    return kernels, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=10**6,
                    help="documents of the paper-config phases (the IVF "
                         "phase always holds 10^6)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.crypto import rlwe
    from repro_torch.kernels import ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- environment + kernel build ---------------------------------------
    card = gpu_line()
    t0 = time.perf_counter()
    ext.extension()             # builds every kernel (ninja, in parallel)
    build_s = time.perf_counter() - t0
    emit({"phase": "environment", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "build_s": build_s})

    emits: list = []
    kernels, paths = flat_phases(torch, np, args, emits)
    # the flat phases' index, dense cache and host pool are gone: the IVF
    # corpus needs their device and host memory
    gc.collect()
    torch.cuda.empty_cache()
    released = dict(device_gb=torch.cuda.memory_allocated() / 1e9,
                    host_rss_gb=Peaks.rss_gb())
    check(released["device_gb"] < 1.0,
          f"flat phases left {released['device_gb']} GB on the device")
    with Peaks(torch) as pk_ivf:
        t0 = time.perf_counter()
        ivf, ivf_paths = ivf_phase(torch, np, args, rlwe.RlweParams())
        ivf_s = time.perf_counter() - t0
    paths += ivf_paths
    launch_tally(kernels, paths)
    emit({"kernels": kernels})
    for line in emits:
        emit(line)
    emit({"phase": "ivf_ingest", "n_docs": IVF_DOCS,
          "clusters": IVF_CLUSTERS, "shard_docs": IVF_SHARD_DOCS,
          "ingest_docs": INGEST_DOCS, "released_before": released,
          "phase_s": ivf_s, "memory": pk_ivf.result, **ivf})
    emit({"phase": "summary", "build_s": build_s,
          "host_max_rss_gb": resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss / 1e6,
          "total_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
