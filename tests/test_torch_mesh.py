"""The port's mesh layer against the JAX package's, on the CPU: sharded
search, the RemoteRAG round over a mesh index and the int8 compressed
all-reduce.

The port's ranks are four ``gloo`` processes, spawned once for the module
(`torch.multiprocessing.spawn`, a ``FileStore`` rendezvous under a
temporary directory, one intra-op thread each); they run meshes (4,)
``("data",)`` and (2, 2) ``("data", "model")``, then rank 0 alone a world
of one started from ``torchrun``'s environment variables, mesh (1,).  The
reference runs once, in a subprocess with 8 virtual CPU devices and Auto
mesh axes (jax 0.9's ``jax.make_mesh`` defaults to Explicit axes, which
its ``shard_map`` specs refuse), and writes its results to an ``.npz``.
This module imports no JAX.

Tolerances: search values within rtol 1e-5 of the reference (XLA's dot
and the port's row-block sums round differently), ids equal; the port's
mesh search equals its flat scan bit for bit (a score's bits depend on its
(query, row) pair alone); the round and the compressed all-reduce bit for
bit.
"""

import os
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.core import planner, protocol
from repro_torch.crypto import rlwe
from repro_torch.data import synth
from repro_torch.launch import mesh as mesh_lib
from repro_torch.retrieval.index import FlatIndex, IvfConfig
from repro_torch.retrieval.topk import distributed_topk, make_sharded_topk
from repro_torch.serve import batching
from repro_torch.train import compress

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MESHES = {"4": ((4,), ("data",)), "2x2": ((2, 2), ("data", "model"))}
# (name, k, keyword arguments): k > rows_local on every mesh for "wide";
# one candidate per 8-row tile for "loose" (exact False, as the reference)
SEARCHES = (("k25", 25, {}), ("wide", 300, {}),
            ("loose", 10, dict(tile=8, per_tile_k=1)))
TP = rlwe.RlweParams(n_poly=1024, chunk=512)
ROUND_DOCS, ROUND_DIM, ROUND_K, ROUND_Q = 400, 64, 3, 2

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.kernels.scoretopk import ref as sref
from repro.retrieval.index import FlatIndex
from repro.retrieval.topk import distributed_topk
from repro.train import compress

def auto_mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

inp = np.load(sys.argv[1])
e, q, g = inp["e"], inp["q"], inp["g"]
out = {}
for k in (25, 300, 10):
    v, i = sref.topk_ref(jnp.asarray(q), jnp.asarray(e), k)
    out[f"ref_{k}_v"], out[f"ref_{k}_i"] = np.asarray(v), np.asarray(i)
mesh = auto_mesh((4, 2), ("data", "model"))
idx = FlatIndex.build(e, mesh=mesh)
for name, k, kw in (("k25", 25, {}), ("wide", 300, {}),
                    ("loose", 10, dict(tile=8, per_tile_k=1))):
    r = distributed_topk(idx, jnp.asarray(q), k, **kw)
    out[f"mesh_{name}_v"] = np.asarray(r.values)
    out[f"mesh_{name}_i"] = np.asarray(r.indices)
    out[f"mesh_{name}_exact"] = np.asarray(bool(r.exact))
mesh4 = auto_mesh((4,), ("data",))
gs = jax.device_put(jnp.asarray(g), NamedSharding(mesh4, P("data", None)))
transform = compress.make_compressed_psum(mesh4, ("data",))
with mesh4:
    out["psum"] = np.asarray(jax.jit(lambda x: transform({"w": x}))(gs)["w"])
np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(7)
    e = rng.normal(size=(1000, 96)).astype(np.float32)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    q = rng.normal(size=(4, 96)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    g = np.random.default_rng(0).normal(size=(4, 256)).astype(np.float32)
    with socket.socket() as sock:           # a free port for the env:// world
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return dict(e=e, q=q, g=g, port=np.array(port))


def _round_world():
    """(index rows, documents, queries, plan) of the round's corpus."""
    rng = np.random.default_rng(3)
    emb = synth.uniform_corpus(rng, ROUND_DOCS, ROUND_DIM)
    docs = [f"passage-{i}".encode() for i in range(ROUND_DOCS)]
    queries = synth.queries_near_corpus(rng, emb, ROUND_Q)
    plan = planner.plan(n=ROUND_DIM, N=ROUND_DOCS, k=ROUND_K, radius=0.05)
    return emb, docs, queries, plan


def _round(index, docs, queries, plan, gen_seed: int) -> dict:
    """``ROUND_Q`` requests through ``run_remoterag``, then the same
    requests as one batch (perturb, top-k', encrypted scores, decrypt);
    the DistanceDP generators are seeded from ``gen_seed``."""
    cloud = protocol.RemoteRagCloud(index, rlwe_params=TP)
    user = lambda: protocol.RemoteRagUser(
        n=ROUND_DIM, N=ROUND_DOCS, k=ROUND_K, plan=plan, rlwe_params=TP,
        rng=np.random.default_rng(11), device="cpu")
    gens = lambda: [torch.Generator().manual_seed(gen_seed + j)
                    for j in range(ROUND_Q)]
    out = {}
    u = user()
    for j, g in enumerate(gens()):
        got_docs, ids, tr = protocol.run_remoterag(u, cloud, queries[j], g)
        assert got_docs == [docs[int(i)] for i in ids]
        out[f"ids{j}"] = ids
        out[f"bytes{j}"] = np.array([tr.request_bytes, tr.reply_bytes,
                                     tr.fetch_bytes, tr.docs_bytes])
    u = user()
    pert = batching.perturb_batch(gens(), queries, [plan.eps] * ROUND_Q,
                                  device="cpu")
    res = batching.topk_batch(index, pert, plan.kprime)
    enc = [u.encrypt_query(e) for e in queries]
    sc = batching.encrypted_scores_cached_batch(TP, enc, cloud.candidate_cache,
                                                res.indices)
    out["batch_ids"] = res.indices.numpy()
    out["batch_scores"] = np.stack(batching.decrypt_scores_batch(
        [u.sk] * ROUND_Q, sc))
    return out


def _searches(index, q, prefix: str, out: dict) -> None:
    for name, k, kw in SEARCHES:
        r = distributed_topk(index, torch.from_numpy(q), k, **kw)
        out[f"{prefix}_{name}_v"] = r.values.numpy()
        out[f"{prefix}_{name}_i"] = r.indices.numpy()
        out[f"{prefix}_{name}_exact"] = np.array(r.exact)


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    inp = np.load(d / "inputs.npz")
    out = {}
    mesh_lib.init_ranks("gloo", store_path=d / "store4", rank=rank,
                        world_size=WORLD, timeout_s=120)
    try:
        for tag, (shape, axes) in MESHES.items():
            mesh = mesh_lib.make_mesh(shape, axes, device="cpu",
                                      backend="gloo")
            index = FlatIndex.build(inp["e"], mesh=mesh)
            out[f"{tag}_rows"] = np.array([index.num_rows,
                                           index.embeddings.shape[0]])
            _searches(index, inp["q"], tag, out)
            # a rank's queries are ignored: the first rank's are searched
            search = make_sharded_topk(mesh, index.row_axes, index.num_rows,
                                       25)
            r = search(torch.from_numpy(np.roll(inp["q"], rank, axis=0)),
                       index.embeddings)
            out[f"{tag}_bcast_i"] = r.indices.numpy()
            # a pinned view searches the same; rows and slices are global
            r = distributed_topk(index.corpus_view(),
                                 torch.from_numpy(inp["q"]), 25)
            out[f"{tag}_view_i"] = r.indices.numpy()
            out[f"{tag}_rows_at"] = index.rows([0, 5, 999, 250]).numpy()
            out[f"{tag}_slice"] = index.slice_view(240, 510).embeddings.numpy()
            out[f"{tag}_view_slice"] = index.corpus_view().slice_view(
                240, 510).embeddings.numpy()
            for what, fn in (
                    ("ingest", lambda: index.ingest(inp["e"][:2])),
                    ("ivf", lambda: FlatIndex.build(
                        inp["e"], mesh=mesh, ivf=IvfConfig(num_clusters=2)))):
                try:
                    fn()
                    out[f"{tag}_{what}_error"] = np.array("")
                except ValueError as err:
                    out[f"{tag}_{what}_error"] = np.array(str(err))
        # 998 rows over 4 shards: two zero rows of padding
        mesh = mesh_lib.make_mesh((4,), ("data",), device="cpu",
                                  backend="gloo")
        index = FlatIndex.build(inp["e"][:998], mesh=mesh)
        r = distributed_topk(index, torch.from_numpy(inp["q"]), 25)
        out["pad_rows"] = np.array([index.num_rows, index.embeddings.shape[0]])
        out["pad_v"], out["pad_i"] = r.values.numpy(), r.indices.numpy()
        mesh = mesh_lib.make_mesh((4,), ("data",), device="cpu",
                                  backend="gloo")
        psum = compress.make_compressed_psum(mesh, ("data",))
        out["psum"] = psum({"w": torch.from_numpy(
            inp["g"][rank:rank + 1].copy())})["w"].numpy()
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu",
                                  backend="gloo")
        emb, docs, queries, plan = _round_world()
        index = FlatIndex.build(emb, documents=docs, mesh=mesh)
        # each rank draws its own perturbation; rank 0's is searched
        out.update({f"round_{k}": v for k, v in _round(
            index, docs, queries, plan, 100 + 17 * rank).items()})
        out["copies"] = np.array(mesh.repro_comms.host_copies)
    finally:
        mesh_lib.shutdown()
    if rank == 0:
        # torchrun's environment (env://) this time, on a free local port
        os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(int(inp["port"])))
        mesh_lib.init_ranks("gloo", timeout_s=120)
        try:
            mesh = mesh_lib.make_mesh((1,), ("data",), device="cpu",
                                      backend="gloo")
            _searches(FlatIndex.build(inp["e"], mesh=mesh), inp["q"], "1",
                      out)
        finally:
            mesh_lib.shutdown()
    np.savez(d / f"rank{rank}.npz", **out)


def _join(ctx, deadline_s: float = 240.0) -> None:
    """Wait for spawned ranks; a rank's exception re-raises here."""
    t_end = time.monotonic() + deadline_s
    while not ctx.join(timeout=1):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {deadline_s} s")


def _stop(ref, ctx) -> None:
    """Leave no reference process or rank running."""
    if ref.poll() is None:
        ref.kill()
    for p in ctx.processes if ctx is not None else ():
        if p.is_alive():
            p.kill()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, reference results, inputs, single-process round)."""
    d = tmp_path_factory.mktemp("mesh")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d / "inputs.npz"),
                            str(d / "ref.npz")], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
        emb, docs, queries, plan = _round_world()
        single = _round(FlatIndex.build(emb, documents=docs, device="cpu"),
                        docs, queries, plan, 100)
        flat_index, flat = FlatIndex.build(inp["e"], device="cpu"), {}
        _searches(flat_index, inp["q"], "flat", flat)
        flat["rows_at"] = flat_index.rows([0, 5, 999, 250]).numpy()
        flat["slice"] = flat_index.slice_view(240, 510).embeddings.numpy()
        r = distributed_topk(FlatIndex.build(inp["e"][:998], device="cpu"),
                             torch.from_numpy(inp["q"]), 25)
        flat["pad_v"], flat["pad_i"] = r.values.numpy(), r.indices.numpy()
        _join(ctx)
        _, err = ref.communicate(timeout=300)
    finally:
        _stop(ref, ctx)
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return types.SimpleNamespace(ranks=ranks, ref=dict(np.load(d / "ref.npz")),
                                 inp=inp, single=single, flat=flat)


@pytest.mark.parametrize("tag", ["1", "4", "2x2"])
def test_sharded_search_matches_reference(runs, tag):
    ranks = runs.ranks[:1] if tag == "1" else runs.ranks
    shards = {"1": 1, "4": 4, "2x2": 4}[tag]
    for out in ranks:
        for name, k, _ in SEARCHES[:2]:
            v, i = out[f"{tag}_{name}_v"], out[f"{tag}_{name}_i"]
            np.testing.assert_array_equal(i, runs.ref[f"ref_{k}_i"])
            np.testing.assert_array_equal(i, runs.ref[f"mesh_{name}_i"])
            np.testing.assert_allclose(v, runs.ref[f"ref_{k}_v"], rtol=1e-5)
            assert bool(out[f"{tag}_{name}_exact"])
            # the flat scan, bit for bit
            np.testing.assert_array_equal(v, runs.flat[f"flat_{name}_v"])
            np.testing.assert_array_equal(i, runs.flat[f"flat_{name}_i"])
        if tag != "1":
            assert tuple(out[f"{tag}_rows"]) == (1000, 1000 // shards)


@pytest.mark.parametrize("tag", ["1", "4", "2x2"])
def test_loose_per_tile_k_is_not_exact(runs, tag):
    """per_tile_k < k: one candidate per 8-row tile; like the reference's
    mesh search, the certificate fails, and every returned value is its
    id's score, in descending order."""
    assert not bool(runs.ref["mesh_loose_exact"])
    e, q = runs.inp["e"].astype(np.float64), runs.inp["q"].astype(np.float64)
    for out in runs.ranks[:1] if tag == "1" else runs.ranks:
        assert not bool(out[f"{tag}_loose_exact"])
        v, i = out[f"{tag}_loose_v"], out[f"{tag}_loose_i"]
        assert np.all(np.diff(v, axis=1) <= 0)
        truth = np.einsum("bkn,bn->bk", e[i], q)
        np.testing.assert_allclose(v, truth, rtol=1e-5, atol=1e-6)


def test_padding_counts_rows_and_search_uses_first_rank_queries(runs):
    """998 rows over 4 shards are padded with zero rows to 1000, which
    ``num_rows`` counts, and the search equals the flat scan of the 998;
    the queries searched are the first rank's."""
    for out in runs.ranks:
        assert tuple(out["pad_rows"]) == (1000, 250)
        np.testing.assert_array_equal(out["pad_v"], runs.flat["pad_v"])
        np.testing.assert_array_equal(out["pad_i"], runs.flat["pad_i"])
        for tag in ("4", "2x2"):
            np.testing.assert_array_equal(out[f"{tag}_bcast_i"],
                                          runs.flat["flat_k25_i"])


@pytest.mark.parametrize("tag", ["4", "2x2"])
def test_mesh_index_views_rows_and_refusals(runs, tag):
    """A pinned view of a mesh index searches as the index does;
    ``rows`` and ``slice_view`` read global ids across the blocks; a mesh
    index takes no ingest and no IVF, as in the reference."""
    e = runs.inp["e"]
    for out in runs.ranks:
        np.testing.assert_array_equal(out[f"{tag}_view_i"],
                                      runs.flat["flat_k25_i"])
        np.testing.assert_array_equal(out[f"{tag}_rows_at"],
                                      runs.flat["rows_at"])
        np.testing.assert_array_equal(out[f"{tag}_slice"],
                                      runs.flat["slice"])
        np.testing.assert_array_equal(out[f"{tag}_view_slice"],
                                      runs.flat["slice"])
        assert "unsharded" in str(out[f"{tag}_ingest_error"])
        assert "mesh-sharded" in str(out[f"{tag}_ivf_error"])
    assert runs.flat["slice"].shape == (270, e.shape[1])


def test_round_over_mesh_equals_single_process(runs):
    """run_remoterag and the batched round over a (2, 2) mesh index: every
    rank returns the single-process round's ids, decrypted scores and
    wire bytes bit for bit, although each rank drew its own perturbation
    (the first rank's is searched)."""
    for out in runs.ranks:
        for key, want in runs.single.items():
            np.testing.assert_array_equal(out[f"round_{key}"], want, key)
        assert int(out["copies"]) == 0          # CPU tensors: no staging


def test_compressed_psum_matches_reference(runs):
    g = runs.inp["g"]
    want = runs.ref["psum"]
    scale = np.abs(g).max() / 127.0
    for rank, out in enumerate(runs.ranks):
        np.testing.assert_array_equal(out["psum"], want[rank:rank + 1])
        assert np.max(np.abs(out["psum"][0] - g.sum(axis=0))) <= \
            4 * scale + 1e-5


def test_mesh_axes_helpers():
    """The reference's ``test_mesh_axes_helpers`` on the port: names only,
    no device state, and the production mesh's shape without building it."""
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert mesh_lib.batch_axes(fake) == ("data",)
    assert mesh_lib.row_axes(fake) == ("data", "model")
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert mesh_lib.batch_axes(pod) == ("pod", "data")
    assert mesh_lib.row_axes(pod) == ("pod", "data", "model")
    assert mesh_lib.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert mesh_lib.production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))


def test_mesh_needs_started_ranks_and_known_backend():
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_ranks("mpi", store_path="unused", rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="init_ranks"):
        mesh_lib.make_mesh((1,), ("data",), device="cpu", backend="gloo")


def test_shard_spec_entries():
    """``PartitionSpec``-style entries: None, an axis, a tuple of axes."""
    spec = mesh_lib.ShardSpec.of(None, "data", ("data", "model"))
    assert spec.dims == ((), ("data",), ("data", "model"))
    assert mesh_lib.ShardSpec.of(("data",)) == mesh_lib.ShardSpec.of("data")
    assert mesh_lib.ShardSpec.of().dims == ()
