"""The port's serving engine and replica router over a mesh index, and the
row-sharded pinned cache shards, against the JAX package's, on the CPU.

The port's ranks are four ``gloo`` processes, spawned once for the module
(`torch.multiprocessing.spawn`, a ``FileStore`` rendezvous, one intra-op
thread each, collectives timing out after 60 s), on meshes (4,)
``("data",)`` and (2, 2) ``("data", "model")``.  The reference runs once,
in a subprocess with 8 virtual CPU devices and Auto mesh axes (jax 0.9's
``jax.make_mesh`` defaults to Explicit axes): its engine, a 2-replica
router and its sharded cache with ``_shard_sharding`` over a (2, 2) mesh
index.  It first writes the DistanceDP perturbations of the requests' keys
(``jax.random`` cannot be replayed in torch); each rank feeds them to the
port's engine in place of its own draws.  This module imports no JAX.

Every rank must return the reference's ids and wire bytes per request and
its decrypted scores bit for bit, through ``drain()`` and through
``step()`` under per-rank skewed clocks; the router likewise per request.
A lane fault on every rank gives the one-process quarantine results; a
fault on one rank only, in a lane's encryption or inside the collective
search's block scan, raises `MeshDivergence` on every rank, well within
its timeout.  The row-sharded gather equals the dense gather bit for bit,
and each rank's device holds 1/n of the resident shards' bytes.  Closing
an engine releases every process group it made.
"""

import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import protocol
from repro_torch.crypto import rlwe
from repro_torch.data import synth
from repro_torch.kernels.scoretopk import ops as sops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.retrieval.index import FlatIndex
from repro_torch.serve import EngineConfig, ServeEngine, batching
from repro_torch.launch.mesh import MeshDivergence
from repro_torch.serve.router import ReplicaRouter, RouterConfig
from repro_torch.serve.session import SessionManager

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}
N_DOCS, DIM, K, N_REQ = 500, 64, 4, 6
TENANTS = ("alice", "bob", "carol")
MAX_BATCH = 4
TP = rlwe.RlweParams(n_poly=1024, chunk=512)
SHARD_DOCS = 100        # splits over 4 ranks and 500 rows: row-sharded
WHOLE_DOCS = 64         # 500 % 64 != 0: shards stay whole
TIMEOUT_S = 60

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax
from jax.sharding import AxisType
from repro.core import protocol as jp
from repro.crypto import rlwe as jr
from repro.retrieval.index import FlatIndex
from repro.serve import EngineConfig, ServeEngine, batching
from repro.serve.router import ReplicaRouter, RouterConfig
from repro.serve.session import SessionManager

N_REQ, K, TENANTS = 6, 4, ("alice", "bob", "carol")
JP = jr.RlweParams(n_poly=1024, chunk=512)
inp = np.load(sys.argv[1])
emb, queries = inp["emb"], inp["queries"]
docs = [f"passage-{i}".encode() for i in range(emb.shape[0])]
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
index = FlatIndex.build(emb, documents=docs, mesh=mesh)
scores = []
real = jp.RemoteRagUser.positions_from_scores
def record(self, s, n):
    scores.append(np.asarray(s)[:n].copy())
    return real(self, s, n)
jp.RemoteRagUser.positions_from_scores = record
out = {}

def serve(srv):
    for t in TENANTS:
        srv.open_session(t, n=emb.shape[1], N=emb.shape[0], k=K, radius=0.05)
    for i, q in enumerate(queries):
        srv.submit(TENANTS[i % 3], q, key=jax.random.PRNGKey(i))
    return srv.drain()

def keep(tag, results):
    for r in results:
        tr = r.transcript
        out[f"{tag}_ids{r.request_id}"] = np.asarray(r.ids)
        out[f"{tag}_bytes{r.request_id}"] = np.array(
            [tr.request_bytes, tr.reply_bytes, tr.fetch_bytes,
             tr.docs_bytes, tr.total_bytes])

def engine(cache_config=None):
    return ServeEngine(index, config=EngineConfig(
        max_batch=4, max_wait_s=30.0, cache_config=cache_config),
        sessions=SessionManager(rlwe_params=JP, deterministic_seeds=True))

eng = engine()
for t in TENANTS:
    eng.open_session(t, n=emb.shape[1], N=emb.shape[0], k=K, radius=0.05)
eps = eng.sessions.get("alice").plan.eps
pert = np.asarray(batching.perturb_batch(
    [jax.random.PRNGKey(i) for i in range(N_REQ)], queries, [eps] * N_REQ))
np.save(sys.argv[2] + ".tmp.npy", pert)
os.replace(sys.argv[2] + ".tmp.npy", sys.argv[2])
keep("engine", serve(eng))
out["engine_scores"] = np.stack(scores)
eng.close()
shard_bytes = 100 * JP.num_chunks(emb.shape[1]) * JP.num_primes * JP.n_poly * 4
for tag, docs_per in (("rows", 100), ("whole", 64)):
    cfg = jr.CandidateCacheConfig(shard_docs=docs_per,
                                  max_resident_bytes=2 * shard_bytes,
                                  async_admission=False)
    out[f"{tag}_placed"] = np.array(index._shard_sharding(JP, cfg) is not None)
    eng = engine(cfg)
    keep(tag, serve(eng))
    cache = index.candidate_cache(JP, cfg)
    out[f"{tag}_gather"] = np.asarray(cache.gather(inp["gather_ids"]))
    eng.close()
rt = ReplicaRouter(index, config=RouterConfig(
    num_replicas=2, engine=EngineConfig(max_batch=4, max_wait_s=30.0)),
    sessions=SessionManager(rlwe_params=JP, deterministic_seeds=True))
keep("router", serve(rt))
rt.close()
np.savez(sys.argv[3], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    emb = synth.uniform_corpus(rng, N_DOCS, DIM)
    queries = synth.queries_near_corpus(rng, emb, N_REQ)
    gather_ids = np.array([[0, 1, 99, 100, 250, 499, 7, 7],
                           [498, 3, 301, 302, 180, 60, 0, 399]])
    return dict(emb=emb, queries=queries, gather_ids=gather_ids)


def _docs():
    return [f"passage-{i}".encode() for i in range(N_DOCS)]


def _shard_bytes() -> int:
    return SHARD_DOCS * TP.num_chunks(DIM) * TP.num_primes * TP.n_poly * 4


def _reference_perturb(pert: np.ndarray):
    """`batching.perturb_batch` giving the reference's perturbation of a
    request whose key is its index (any other key: the port's own)."""
    real = batching.perturb_batch

    def perturb(generators, E, epss, *, device=None):
        seeds = [g.initial_seed() for g in generators]
        if all(s < len(pert) for s in seeds):
            return torch.from_numpy(pert[seeds].copy())
        return real(generators, E, epss, device=device)

    return perturb


class _Scores:
    """Records every lane's decrypted scores, in finishing order."""

    def __init__(self):
        self.seen = []
        self.real = protocol.RemoteRagUser.positions_from_scores
        rec = self

        def record(user, scores, n):
            rec.seen.append(np.asarray(scores)[:n].copy())
            return rec.real(user, scores, n)

        protocol.RemoteRagUser.positions_from_scores = record

    def take(self) -> np.ndarray:
        out, self.seen = np.stack(self.seen), []
        return out


def _engine(index, *, seeds=True, clock=None, **cfg):
    eng = ServeEngine(index, config=EngineConfig(
        max_batch=MAX_BATCH, **{"max_wait_s": 30.0, **cfg}),
        sessions=SessionManager(rlwe_params=TP, deterministic_seeds=seeds,
                                device="cpu"),
        **({} if clock is None else {"clock": clock}))
    for t in TENANTS:
        eng.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    return eng


def _keep(out: dict, tag: str, results, *, with_sizes=False) -> None:
    for r in results:
        out[f"{tag}_ok{r.request_id}"] = np.array(r.ok)
        if not r.ok:
            continue
        tr = r.transcript
        out[f"{tag}_ids{r.request_id}"] = np.asarray(r.ids)
        out[f"{tag}_bytes{r.request_id}"] = np.array(
            [tr.request_bytes, tr.reply_bytes, tr.fetch_bytes,
             tr.docs_bytes, tr.total_bytes])
    if with_sizes:
        out[f"{tag}_sizes"] = np.array([r.batch_size for r in results])


def _submit(srv, queries, keys=True):
    for i, q in enumerate(queries):
        srv.submit(TENANTS[i % len(TENANTS)], q, key=i if keys else None)


class _PoisonFetch:
    """The fetch of one request's ids raises (batched and retried)."""

    def __init__(self, cloud, ids):
        self.cloud, self.ids = cloud, [int(i) for i in ids]

    def __call__(self, cand_ids, msg):
        if [int(cand_ids[p]) for p in msg.positions] == self.ids:
            raise RuntimeError("persistently poisoned lane")
        return type(self.cloud).handle_fetch(self.cloud, cand_ids, msg)


def _mesh_cases(rank: int, tag: str, mesh, inp, scores: _Scores,
                out: dict) -> None:
    queries = inp["queries"]
    index = FlatIndex.build(inp["emb"], documents=_docs(), mesh=mesh)
    # drain(): the reference's ids, wire bytes and decrypted scores
    eng = _engine(index)
    _submit(eng, queries)
    got = eng.drain()
    eng.close()
    _keep(out, f"{tag}_drain", got)
    out[f"{tag}_drain_scores"] = scores.take()
    poison = got[0].ids
    # step() under a clock that runs at another rate on every rank: a
    # deadline fires at different steps unless the first rank decides
    now = [0.0]
    eng = _engine(index, max_wait_s=0.5,
                  clock=lambda: now[0] * (1.0 + 0.6 * rank) + rank)
    stepped = []
    for i, q in enumerate(queries):
        eng.submit(TENANTS[i % len(TENANTS)], q, key=i)
        now[0] += 0.3
        stepped += eng.step()
    stepped += eng.drain()
    eng.close()
    _keep(out, f"{tag}_step", sorted(stepped, key=lambda r: r.request_id),
          with_sizes=True)
    out[f"{tag}_step_scores"] = scores.take()
    # random session seeds and keys: the first rank's, on every rank
    eng = _engine(index, seeds=False)
    _submit(eng, queries, keys=False)
    _keep(out, f"{tag}_random", eng.drain())
    eng.close()
    scores.take()
    # a lane fault on every rank: quarantined as in one process
    eng = _engine(index)
    eng.cloud.handle_fetch = _PoisonFetch(eng.cloud, poison)
    _submit(eng, queries)
    got = eng.drain()
    eng.close()
    _keep(out, f"{tag}_poison", got)
    out[f"{tag}_poison_quarantined"] = np.array(
        [r.quarantined for r in got])
    scores.take()
    # a fault on rank 1 only: every rank raises, well within its timeout,
    # whether it hits a lane's encryption or the collective search's scan
    enc = lambda eng: eng.sessions.get("bob").user
    scan = lambda eng: sops
    cases = [("diverged", index, enc, "encrypt_query"),
             ("scan_diverged", index, scan, "topk_scores")]
    if len(mesh.mesh_dim_names) > 1:
        # rows over the first axis only: rank 1's row group parts ways and
        # tells the other group, which waits at its next agreement
        rows = FlatIndex.build(inp["emb"], documents=_docs(), mesh=mesh,
                               row_axes=mesh.mesh_dim_names[:1])
        rows.all_rows()         # the base mesh's group over that axis
        cases.append(("scan_diverged_rows", rows, scan, "topk_scores"))
    groups = len(dist.distributed_c10d._world.pg_map)
    for case, case_index, owner, attr in cases:
        eng = _engine(case_index)
        real = getattr(owner(eng), attr)

        def broken(*a, **kw):
            raise RuntimeError("rank 1 lost its lane")

        if rank == 1:
            setattr(owner(eng), attr, broken)
        _submit(eng, queries)
        t0 = time.monotonic()
        try:
            eng.drain()
            out[f"{tag}_{case}"] = np.array("")
        except MeshDivergence as e:
            out[f"{tag}_{case}"] = np.array(str(e))
        out[f"{tag}_{case}_s"] = np.array(time.monotonic() - t0)
        setattr(owner(eng), attr, real)
        eng.close(shed_pending=True)
        scores.seen = []
    out[f"{tag}_groups_left"] = np.array(
        len(dist.distributed_c10d._world.pg_map) - groups)
    # the sharded cache: row-sharded pinned shards, and whole ones
    for cache_tag, docs_per in (("rows", SHARD_DOCS), ("whole", WHOLE_DOCS)):
        cfg = rlwe.CandidateCacheConfig(
            shard_docs=docs_per, max_resident_bytes=2 * _shard_bytes(),
            async_admission=False)
        eng = _engine(index, cache_config=cfg)
        _submit(eng, queries)
        _keep(out, f"{tag}_{cache_tag}", eng.drain())
        cache = index.candidate_cache(TP, cfg)
        g = cache.gather(inp["gather_ids"])
        st = cache.stats()
        out[f"{tag}_{cache_tag}_gather"] = g.numpy()
        out[f"{tag}_{cache_tag}_placed"] = np.array(
            cache.placement is not None)
        out[f"{tag}_{cache_tag}_bytes"] = np.array(
            [st["resident_bytes"], st["device_resident_bytes"],
             st["peak_resident_bytes"], len(st["resident_shards"])])
        eng.close()
        scores.take()
    dense = index.candidate_cache(TP)
    out[f"{tag}_dense_gather"] = dense.polys[
        torch.from_numpy(inp["gather_ids"])].numpy()
    # the router: 2 replicas, each on its own step thread
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=2, engine=EngineConfig(max_batch=MAX_BATCH,
                                            max_wait_s=30.0)),
        sessions=SessionManager(rlwe_params=TP, deterministic_seeds=True,
                                device="cpu"))
    for t in TENANTS:
        rt.open_session(t, n=DIM, N=N_DOCS, k=K, radius=0.05)
    _submit(rt, queries)
    _keep(out, f"{tag}_router", rt.drain())
    rt.close()
    scores.take()


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    inp = dict(np.load(d / "inputs.npz"))
    t_end = time.monotonic() + 180
    while not (d / "pert.npy").exists():      # the reference's first output
        if time.monotonic() > t_end:
            raise TimeoutError("the reference wrote no perturbations")
        time.sleep(0.2)
    batching.perturb_batch = _reference_perturb(np.load(d / "pert.npy"))
    scores = _Scores()
    out = {}
    mesh_lib.init_ranks("gloo", store_path=d / "store", rank=rank,
                        world_size=WORLD, timeout_s=TIMEOUT_S)
    try:
        for tag, (shape, axes) in MESHES.items():
            mesh = mesh_lib.make_mesh(shape, axes, device="cpu",
                                      backend="gloo")
            _mesh_cases(rank, tag, mesh, inp, scores, out)
    finally:
        mesh_lib.shutdown()
    np.savez(d / f"rank{rank}.npz", **out)


def _join(ctx, deadline_s: float) -> None:
    """Wait for spawned ranks; a rank's exception re-raises here."""
    t_end = time.monotonic() + deadline_s
    while not ctx.join(timeout=1):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {deadline_s} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, reference results, one-process port results)."""
    d = tmp_path_factory.mktemp("engine_mesh")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d / "inputs.npz"),
                            str(d / "pert.npy"), str(d / "ref.npz")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
        _join(ctx, 300.0)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
        for p in ctx.processes if ctx is not None else ():
            if p.is_alive():
                p.kill()
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    # the port in one process, with the same perturbations and poison
    real = batching.perturb_batch
    batching.perturb_batch = _reference_perturb(np.load(d / "pert.npy"))
    try:
        single = {}
        index = FlatIndex.build(inp["emb"], documents=_docs(), device="cpu")
        eng = _engine(index)
        _submit(eng, inp["queries"])
        poison = eng.drain()[0].ids
        eng.close()
        eng = _engine(index)
        eng.cloud.handle_fetch = _PoisonFetch(eng.cloud, poison)
        _submit(eng, inp["queries"])
        got = eng.drain()
        eng.close()
        _keep(single, "poison", got)
        single["poison_quarantined"] = np.array([r.quarantined for r in got])
    finally:
        batching.perturb_batch = real
    return types.SimpleNamespace(ranks=ranks, ref=dict(np.load(d / "ref.npz")),
                                 single=single, inp=inp)


def _same_requests(got: dict, gtag: str, want: dict, wtag: str) -> None:
    for i in range(N_REQ):
        assert bool(got[f"{gtag}_ok{i}"]), (gtag, i)
        np.testing.assert_array_equal(got[f"{gtag}_ids{i}"],
                                      want[f"{wtag}_ids{i}"], f"{gtag} {i}")
        np.testing.assert_array_equal(got[f"{gtag}_bytes{i}"],
                                      want[f"{wtag}_bytes{i}"], f"{gtag} {i}")


@pytest.mark.parametrize("tag", list(MESHES))
def test_engine_drain_matches_reference(runs, tag):
    """drain() over a mesh index: every rank returns the reference
    engine's ids and wire bytes per request, and its decrypted scores bit
    for bit."""
    for out in runs.ranks:
        _same_requests(out, f"{tag}_drain", runs.ref, "engine")
        np.testing.assert_array_equal(out[f"{tag}_drain_scores"],
                                      runs.ref["engine_scores"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_engine_step_under_skewed_clocks(runs, tag):
    """step() with a clock that runs at another rate on every rank: the
    first rank's batches are every rank's, and each request's ids, wire
    bytes and decrypted scores are the reference's."""
    sizes = runs.ranks[0][f"{tag}_step_sizes"]
    assert len(set(sizes.tolist())) > 1        # deadlines cut the batches
    for out in runs.ranks:
        _same_requests(out, f"{tag}_step", runs.ref, "engine")
        np.testing.assert_array_equal(out[f"{tag}_step_sizes"], sizes)
        np.testing.assert_array_equal(out[f"{tag}_step_scores"],
                                      runs.ref["engine_scores"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_random_seeds_and_keys_are_the_first_ranks(runs, tag):
    """Sessions opened without seeds and requests without keys: every rank
    serves the first rank's keys, so all ranks return the same results."""
    first = runs.ranks[0]
    for out in runs.ranks[1:]:
        _same_requests(out, f"{tag}_random", first, f"{tag}_random")


@pytest.mark.parametrize("tag", list(MESHES))
def test_lane_fault_on_every_rank_is_quarantined_as_one_process(runs, tag):
    single = runs.single
    for out in runs.ranks:
        np.testing.assert_array_equal(out[f"{tag}_poison_quarantined"],
                                      single["poison_quarantined"])
        for i in range(N_REQ):
            assert bool(out[f"{tag}_poison_ok{i}"]) == \
                bool(single[f"poison_ok{i}"])
            if bool(single[f"poison_ok{i}"]):
                np.testing.assert_array_equal(out[f"{tag}_poison_ids{i}"],
                                              single[f"poison_ids{i}"])
    assert not bool(single["poison_ok0"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_fault_on_one_rank_raises_on_every_rank(runs, tag):
    for out in runs.ranks:
        assert "differ across ranks" in str(out[f"{tag}_diverged"])
        assert float(out[f"{tag}_diverged_s"]) < TIMEOUT_S / 2


@pytest.mark.parametrize("tag", list(MESHES))
def test_scan_fault_on_one_rank_raises_on_every_rank(runs, tag):
    """The score-top-k scan of the collective search fails on rank 1 only:
    every rank raises `MeshDivergence` from the search's own agreement,
    well before the collectives' timeout, and the engines' close releases
    every process group they made."""
    for out in runs.ranks:
        assert "block scan failed on the shards at positions [1]" in \
            str(out[f"{tag}_scan_diverged"])
        assert float(out[f"{tag}_scan_diverged_s"]) < TIMEOUT_S / 2
        assert int(out[f"{tag}_groups_left"]) == 0


def test_scan_fault_in_one_row_group_raises_on_every_rank(runs):
    """Rows split over "data" only of the (2, 2) mesh: the scan fails on
    rank 1, so its row group {1, 3} parts ways inside the search, and the
    other group {0, 2}, past its search, learns it at the next
    agreement: every rank raises, well before the collectives' timeout."""
    for rank, out in enumerate(runs.ranks):
        msg = str(out["2x2_scan_diverged_rows"])
        if rank % 2:
            assert "block scan failed on the shards at positions [0]" in msg
        else:
            assert "differ across ranks" in msg
        assert float(out["2x2_scan_diverged_rows_s"]) < TIMEOUT_S / 2


@pytest.mark.parametrize("tag", list(MESHES))
def test_router_matches_reference(runs, tag):
    """A 2-replica router over the mesh index, each replica stepping on its
    own thread: the reference router's ids and wire bytes per request."""
    for out in runs.ranks:
        _same_requests(out, f"{tag}_router", runs.ref, "router")


@pytest.mark.parametrize("tag", list(MESHES))
def test_row_sharded_pinned_shards(runs, tag):
    """shard_docs = 100 splits over the 4 row ranks and 500 rows: the
    reference row-shards its pinned shards and so does the port; a rank
    holds 1/4 of the two resident shards' bytes; the gather equals the
    dense gather and the reference's bit for bit, and the engine the
    reference's per request.  shard_docs = 64 leaves the shards whole."""
    assert bool(runs.ref["rows_placed"]) and not bool(runs.ref["whole_placed"])
    for out in runs.ranks:
        for cache_tag in ("rows", "whole"):
            assert bool(out[f"{tag}_{cache_tag}_placed"]) == \
                bool(runs.ref[f"{cache_tag}_placed"])
            np.testing.assert_array_equal(out[f"{tag}_{cache_tag}_gather"],
                                          out[f"{tag}_dense_gather"])
            np.testing.assert_array_equal(out[f"{tag}_{cache_tag}_gather"],
                                          runs.ref[f"{cache_tag}_gather"])
            _same_requests(out, f"{tag}_{cache_tag}", runs.ref, cache_tag)
        whole, device, peak, shards = out[f"{tag}_rows_bytes"]
        assert shards == 2 and whole == 2 * _shard_bytes() == peak
        assert device * WORLD == whole
        whole, device, _, _ = out[f"{tag}_whole_bytes"]
        assert device == whole
