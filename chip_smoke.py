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
     score-top-k at one query (``at_shapes``); the fused re-rank reads gathered rows in
     place, as the serving path hands them over;
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
     the runs and recall@5 = 1.0.

Each path (one-at-a-time, batch, each engine run) runs with the launch
counts set to 0 just before it and read just after, and every kernel of
the path must have launched; the kernels line gives each kernel's launches
over the paths, also by shape, and launches x (time - bound) per timed
shape.  Every phase prints one JSON line with its
wall time; the last line is the device summary.  Any failed check raises,
so the script exits non-zero and prints no result.  It needs a CUDA device
and the repository's ``src/`` beside it.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import math
import resource
import statistics
import subprocess
import sys
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
NUM_SHARDS, BUDGET_SHARDS = 16, 4   # sharded cache: shards, engine budget
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
    # most launches)
    emb = index.embeddings
    n_rows, dim = emb.shape
    tile, kk = 2048, min(plan.kprime, 2048, n_rows)
    num_tiles = -(-n_rows // tile)
    pad = num_tiles * tile - n_rows
    timed = []
    for b in (1, bsz):
        q = torch.from_numpy(np.asarray(queries[:b], np.float32)).to(dev)
        kv, ki = kscore.score_topk_cuda(q, emb, kk=kk, tile=tile)
        pv, pi = sref.tile_topk_ref(q, emb, kk, tile)
        fin = torch.isfinite(pv)
        check(torch.equal(fin, torch.isfinite(kv)), "score_topk -inf pattern")
        err = (kv[fin] - pv[fin]).abs()
        check(bool((err <= 1e-5 * pv[fin].abs() + 1e-30).all()),
              f"score_topk values off by {float(err.max())}")
        mism = (ki != pi) & fin
        if bool(mism.any()):
            # a swapped id must score, under the plain version, within the
            # tolerance of the plain value at that position (a tie)
            t_idx, b_idx, _ = torch.nonzero(mism, as_tuple=True)
            got_ids = ki[mism].long()
            rescored = (q[b_idx].double() * emb[got_ids].double()).sum(-1)
            ok = (rescored - pv[mism].double()).abs() <= 1e-5 * pv[mism].abs()
            check(bool(ok.all()), "score_topk ids differ beyond score ties")

        def library(q=q, b=b):
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
            lambda q=q: kscore.score_topk_cuda(q, emb, kk=kk, tile=tile),
            lambda q=q: sref.tile_topk_ref(q, emb, kk, tile),
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


def launch_tally(kernels: list, paths: list, shape_paths: list) -> None:
    """Each kernel's launches over the paths' runs, in all and by shape;
    each timed row's launches at its own shape and launches x (time -
    bound) (``excess_ms``), the rule-2 ranking of the kernels."""
    for kern in kernels:
        kern["launches"] = sum(p.get(kern["name"], 0) for p in paths)
        by_shape = collections.Counter()
        for p in shape_paths:
            for name, shape, count in p:
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
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.crypto import rlwe
    from repro_torch.kernels import ext
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
    out, results = {}, {}
    for name, cfg in runs.items():
        engine = ServeEngine(index, config=cfg, sessions=SessionManager(
            rlwe_params=params, deterministic_seeds=True))
        for t in range(TENANTS):
            engine.open_session(f"tenant-{t}", n=index.dim, N=index.num_rows,
                                k=plan.k, plan_kwargs={"kprime": 160})
        torch.cuda.synchronize()
        ext.reset_launches()
        # batched runs under torch.profiler (CUDA activity only) for the
        # device's busy and idle share of the run's wall time
        prof = (profile(activities=[ProfilerActivity.CUDA])
                if not cfg.sequential else None)
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        for j in range(2 * len(queries)):
            engine.submit(f"tenant-{j % TENANTS}", queries[j % len(queries)],
                          key=args.seed * 1000 + j)
        res = engine.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = None
        if prof is not None:
            prof.__exit__(None, None, None)
            _, busy_ms = device_busy(torch, prof)
        launches = path_launches(f"engine {name}", ext.launch_counts())
        shapes = shape_counts(ext.launch_shapes())
        engine.close()
        check(len(res) == 2 * len(queries) and all(r.ok for r in res),
              f"engine {name}: {[r.error for r in res if not r.ok]}")
        recalls = [len(set(r.ids.tolist()) & set(
            want[r.request_id % len(queries)].tolist())) / plan.k
            for r in res]
        check(all(x == 1.0 for x in recalls),
              f"engine {name}: recall@{plan.k} {recalls}")
        results[name] = res
        summary = engine.metrics.summary()
        agg = summary["aggregate"]
        out[name] = dict(
            wall_ms=wall_ms, num_batches=summary["num_batches"],
            device_busy_ms=busy_ms,
            device_idle_share=(None if busy_ms is None
                               else 1.0 - busy_ms / wall_ms),
            p50_latency_s=agg["p50_latency_s"],
            p99_latency_s=agg["p99_latency_s"],
            mean_latency_s=agg["mean_latency_s"],
            stages=engine.trace_summary()["stages"],
            cache_stats=engine.cache_stats(), launches=launches,
            shapes=shapes)
    base = results["dense_batched"]
    for name, res in results.items():
        for a, b in zip(base, res):
            check(a.request_id == b.request_id
                  and np.array_equal(a.ids, b.ids) and a.docs == b.docs
                  and a.transcript.total_bytes == b.transcript.total_bytes,
                  f"engine {name}: request {b.request_id} differs from the "
                  f"dense batched run")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-docs", type=int, default=10**6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import planner, protocol
    from repro_torch.crypto import rlwe
    from repro_torch.data import synth
    from repro_torch.kernels import ext
    from repro_torch.retrieval.index import FlatIndex

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

    t0 = time.perf_counter()
    kernels = kernel_phase(torch, np, args, index, params, plan, queries)
    kernels_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shared, serve = serve_phase(torch, np, args, index, cloud, params, plan,
                                queries)
    serve_s = time.perf_counter() - t0
    for path in ("launches_seq", "launches_batch"):
        path_launches(path, serve[path])
    t0 = time.perf_counter()
    cache_out = cache_phase(torch, np, args, cache, params, plan, shared)
    cache_phase_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = engine_phase(torch, np, args, index, params, plan, queries,
                          shared)
    engine_s = time.perf_counter() - t0
    paths = [serve["launches_seq"], serve["launches_batch"]] + [
        run["launches"] for run in engine.values()]
    launch_tally(kernels, paths, [serve["shapes_seq"], serve["shapes_batch"]]
                 + [run["shapes"] for run in engine.values()])
    emit({"kernels": kernels})
    emit({"phase": "serve", "n_docs": args.n_docs, "dim": dim, "k": plan.k,
          "kprime": plan.kprime, "path": plan.path, "eps": plan.eps,
          "data_s": data_s, "index_s": index_s, "cache_build_s": cache_s,
          "cache_gb": cache.nbytes / 1e9, "cache_launches": cache_launches,
          "kernels_phase_s": kernels_s, "phase_s": serve_s, **serve})
    emit({"phase": "cache", "num_shards": NUM_SHARDS,
          "phase_s": cache_phase_s, **cache_out})
    emit({"phase": "engine", "requests": 2 * len(queries),
          "tenants": TENANTS, "budget_shards": BUDGET_SHARDS,
          "phase_s": engine_s, "runs": engine,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
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
