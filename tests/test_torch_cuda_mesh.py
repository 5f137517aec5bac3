"""The port's multi-device paths on one card: four ``gloo`` ranks co-located
on the H100, mesh (2, 2) ("data", "model"), against one process.

Marked ``cuda``: on a host without a CUDA device every test here skips.
The ranks are started once for the module with the spawn method (a
``FileStore`` rendezvous; gloo stages the collectives of CUDA tensors
through host memory).  Each rank loads the parent's kernel build and runs,
with the kernels' launch counts set to 0 just before each path:

- the first stage over both axes at 10^6 x 768 (250,000 rows a rank),
  which must equal the flat scan in one process bit for bit;
- 8 requests of 4 tenants through ``run_remoterag`` and again as one batch
  over a 2^17-document mesh index (every rank builds the whole dense
  cache, as the mesh index does: four 10^6-document caches would not share
  a card), equal to one process on the same corpus;
- over that index, 16 requests through a ``ServeEngine`` drained, and
  stepped with a 2 ms deadline under clocks skewed rank by rank, through a
  4-replica ``ReplicaRouter``, and through an engine over 16 cache shards
  with 4 pinned and row-sharded over the ranks: ids, wire bytes and
  decrypted scores equal to one process (the router: ids and bytes);
- the MoE layer of Qwen3-30B-A3B at its published width (tokens over
  "data", experts over "model"), float32 within 1e-5 of the einsum layer in
  one process;
- GPipe on Llama-3-8B at its published width over ("pod", "data"): 2
  float32 layers within the training tolerances of the same model in one
  process, then a bfloat16 step of 4 layers;
- the config_100m re-sharding drill: a checkpoint saved on (2, 2) restored
  on (4,) and in one process, and a run that dies on (2, 2) resumed on
  (4,), bit for bit.

Every serving path launches every kernel of the RLWE path on every rank;
the MoE and training paths launch none of ours.  These files import torch
and numpy only (no JAX).
"""

import dataclasses
import gc
import json
import os
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_cuda_serving as serving
from repro_torch.kernels import ext

# the re-sharding drill runs under torch.use_deterministic_algorithms, whose
# cuBLAS calls need a fixed workspace, set before cuBLAS starts (the ranks
# inherit it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.cuda

WORLD, SHAPE, AXES = 4, (2, 2), ("data", "model")
FIRST_DOCS, ROUND_DOCS = 10**6, 2**17
REQUESTS, TENANTS, SERVE_REQUESTS = 8, 4, 16
NUM_SHARDS, PIN_SHARDS, REPLICAS, WAIT_S = 16, 4, 4, 0.002
MOE_TOKENS = (8, 512)
GPIPE_AXES = ("pod", "data")
GPIPE_PARITY_LAYERS, GPIPE_LAYERS = 2, 4
GPIPE_TOKENS, GPIPE_MICRO = (8, 512), 4
RESHARD_STEPS, RESHARD_EVERY, RESHARD_FAIL = 4, 2, 2
RESHARD_TOKENS = (8, 128)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
SERVING_PATHS = ("engine_drain", "engine_step", "router", "engine_sharded")
TRAINING_PATHS = ("gpipe_parity", "gpipe_bf16", "reshard_restore",
                  "reshard_drill")
RANKS_DEADLINE_S = 900


def configs() -> dict:
    """The published configurations the ranks run (tp = 1)."""
    from repro_torch.configs import registry
    from repro_torch.examples import train_lm

    return dict(
        moe=dataclasses.replace(registry.get("qwen3-moe-30b-a3b").config,
                                tp=1).moe_spec,
        gpipe=dataclasses.replace(registry.get("llama3-8b").config, tp=1,
                                  batch_axes=("data",)),
        reshard=train_lm.config_100m())


def so_mtime() -> float:
    """Modification time of the built extension (0 if there is none)."""
    return max((f.stat().st_mtime for f in ext.BUILD_DIR.glob("*.so")),
               default=0.0)


# -- what a rank and the one process both run ----------------------------------

def users(params, plan, dim, n_docs, seed, device) -> list:
    from repro_torch.core import protocol

    return [protocol.RemoteRagUser(
        n=dim, N=n_docs, k=plan.k, plan=plan, rlwe_params=params,
        rng=np.random.default_rng(seed + 100 + t), device=device)
        for t in range(TENANTS)]


def round_trip(index, docs, queries, plan, params, seed, gen_seed,
               device) -> dict:
    """REQUESTS requests of TENANTS tenants through ``run_remoterag``, then
    the same requests as one batch (perturb_batch -> topk_batch ->
    encrypted_scores_cached_batch -> decrypt_scores_batch), the DistanceDP
    generators seeded from ``gen_seed``.  Returns host arrays: each
    request's ids and wire bytes, whether its documents are its ids', the
    batch's candidates and decrypted scores."""
    from repro_torch.core import protocol
    from repro_torch.serve import batching

    cloud = protocol.RemoteRagCloud(index, rlwe_params=params)

    def gens():
        return [torch.Generator(device=device).manual_seed(gen_seed + j)
                for j in range(len(queries))]

    out, seq = {}, users(params, plan, index.dim, index.num_rows, seed,
                         device)
    for j, g in enumerate(gens()):
        got, ids, tr = protocol.run_remoterag(seq[j % TENANTS], cloud,
                                              queries[j], g)
        out[f"ids{j}"] = np.asarray(ids)
        out[f"bytes{j}"] = np.array([tr.request_bytes, tr.reply_bytes,
                                     tr.fetch_bytes, tr.docs_bytes,
                                     tr.total_bytes])
        out[f"docs_ok{j}"] = np.array(got == [docs[int(i)] for i in ids])
    lanes = users(params, plan, index.dim, index.num_rows, seed, device)
    lanes = [lanes[j % TENANTS] for j in range(len(queries))]
    pert = batching.perturb_batch(gens(), queries, [plan.eps] * len(queries),
                                  device=device)
    res = batching.topk_batch(index, pert, plan.kprime)
    enc = [u.encrypt_query(e) for u, e in zip(lanes, queries)]
    sc = batching.encrypted_scores_cached_batch(
        params, enc, cloud.candidate_cache, res.indices)
    out["batch_ids"] = res.indices.cpu().numpy()
    out["batch_scores"] = np.stack(batching.decrypt_scores_batch(
        [u.sk for u in lanes], sc))
    return out


class ScoreLog:
    """The decrypted scores of every finished lane, in finishing order (a
    patch on ``RemoteRagUser.positions_from_scores`` inside the block)."""

    def __enter__(self) -> "ScoreLog":
        from repro_torch.core import protocol

        self.cls = protocol.RemoteRagUser
        self.real = self.cls.positions_from_scores
        self.seen = []

        def record(user, scores, n):
            self.seen.append(np.asarray(scores)[:n].copy())
            return self.real(user, scores, n)

        self.cls.positions_from_scores = record
        return self

    def __exit__(self, *exc) -> None:
        self.cls.positions_from_scores = self.real


def requests(srv, queries, docs, seed, dim, n_docs, k, knob, *,
             step=False) -> dict:
    """SERVE_REQUESTS requests of TENANTS tenants (keys from ``seed``)
    through ``srv``, drained (with ``step``: one ``step()`` after every
    submit first).  Returns host arrays: ids, wire bytes (request, reply,
    fetch, docs, total), batch sizes, request ids, whether each succeeded
    with the documents of its ids, and the decrypted scores in finishing
    order."""
    for t in range(TENANTS):
        srv.open_session(f"tenant-{t}", n=dim, N=n_docs, k=k,
                         plan_kwargs={"kprime": knob})
    res = []
    with ScoreLog() as log:
        for j in range(SERVE_REQUESTS):
            srv.submit(f"tenant-{j % TENANTS}", queries[j % len(queries)],
                       key=seed * 1000 + j)
            if step:
                res += srv.step()
        res += srv.drain()
    res.sort(key=lambda r: r.request_id)
    tr = [r.transcript for r in res]
    return dict(
        ids=np.stack([np.asarray(r.ids) for r in res]),
        bytes=np.array([[t.request_bytes, t.reply_bytes, t.fetch_bytes,
                         t.docs_bytes, t.total_bytes] for t in tr]),
        sizes=np.array([r.batch_size for r in res]),
        rids=np.array([r.request_id for r in res]),
        ok=np.array([r.ok and r.docs == [docs[int(i)] for i in r.ids]
                     for r in res]),
        scores=np.stack(log.seen))


def moe_inputs(spec, seed, device) -> tuple:
    """(layer, tokens (*MOE_TOKENS, d)) drawn from seeded generators on
    ``device``: the same bits in every process."""
    from repro_torch.models import moe as moe_lib

    gen = torch.Generator(device=device).manual_seed(seed)
    layer = moe_lib.Moe(spec, gen, gen.device)
    gen.manual_seed(seed + 1)
    x = torch.randn(MOE_TOKENS + (spec.d_model,), generator=gen,
                    device=gen.device)
    return layer, x


def drill_run(cfg, device):
    from repro_torch.launch.train import make_lm_run

    return make_lm_run(cfg, batch=RESHARD_TOKENS[0], seq=RESHARD_TOKENS[1],
                       lr=3e-3, steps=RESHARD_STEPS, device=device, seed=0)


def leaves(state) -> list:
    from repro_torch.train import checkpoint as ckpt

    return [t for _, t in ckpt._flatten(state)]


# -- a rank ----------------------------------------------------------------------

def _rank_main(rank: int, workdir: str, cfg: dict) -> None:
    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or WORLD) // WORLD))
    wd = Path(workdir)
    if cfg["device"] == "cuda":
        ext.extension()                 # the parent's build, loaded
    info, arrays = {"rank": rank, "so_mtime": so_mtime()}, {}
    mesh_lib.init_ranks("gloo", store_path=wd / "store", rank=rank,
                        world_size=WORLD, timeout_s=600)
    try:
        _rank_paths(wd, cfg, rank, info, arrays)
    finally:
        mesh_lib.shutdown()
    np.savez(wd / f"rank{rank}.npz", **arrays)
    (wd / f"rank{rank}.json").write_text(json.dumps(info))


def _rank_paths(wd: Path, cfg: dict, rank: int, info: dict,
                arrays: dict) -> None:
    import torch.distributed as dist

    from repro_torch.core import planner
    from repro_torch.data import synth
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.mesh import ShardSpec
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk

    dev = torch.device(cfg["device"])
    mesh = mesh_lib.make_mesh(SHAPE, AXES, device=dev.type, backend="gloo")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def path(name, fn):
        """``fn()`` with the launch counts set to 0 just before it; its
        launches into ``info[name]``."""
        sync()
        dist.barrier()
        ext.reset_launches()
        out = fn()
        sync()
        info[name] = ext.launch_counts()
        return out

    # -- the first stage over both axes ------------------------------------
    index = FlatIndex.build(np.load(wd / "corpus.npy", mmap_mode="r"),
                            mesh=mesh, normalize=False)
    info["first_rows"] = [index.num_rows, index.embeddings.shape[0]]
    q = torch.from_numpy(np.load(wd / "queries.npy")).to(dev)
    res = path("first_stage", lambda: distributed_topk(index, q,
                                                       cfg["kprime"]))
    arrays["first_v"] = res.values.cpu().numpy()
    arrays["first_i"] = res.indices.cpu().numpy()
    del index, res
    torch.cuda.empty_cache()

    # -- the round and the serving paths over a mesh index -------------------
    r = cfg["round"]
    corpus = synth.uniform_corpus(np.random.default_rng(r.seed + 7),
                                  r.n_docs, r.dim)
    queries = synth.queries_near_corpus(np.random.default_rng(r.seed + 8),
                                        corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(r.n_docs)]
    index = FlatIndex.build(corpus, documents=docs, mesh=mesh)
    del corpus
    plan = planner.plan(n=r.dim, N=r.n_docs, k=r.k, kprime=r.knob)
    index.candidate_cache(r.params)     # gathered rows, the whole dense cache
    # each rank draws its own perturbation; the first rank's is searched
    got = path("round", lambda: round_trip(
        index, docs, queries, plan, r.params, r.seed,
        r.gen_seed + 1000 * rank, dev))
    arrays.update({f"round_{k}": v for k, v in got.items()})
    _serving(index, docs, queries, r, rank, dev, info, arrays, path)
    del index
    gc.collect()
    torch.cuda.empty_cache()

    # -- the MoE layer: tokens over "data", experts over "model" -------------
    spec = dataclasses.replace(cfg["moe"], batch_axes=("data",),
                               ep_axis="model", impl="shard_a2a", mesh=mesh)
    layer, x = moe_inputs(spec, r.seed, dev)
    transformer.shard_params(layer, mesh, {
        "router": ShardSpec.of(None, None),
        **{w: ShardSpec.of("model") for w in ("w_gate", "w_up", "w_down")}})
    b_loc = x.shape[0] // mesh_lib.axes_size(mesh, ("data",))
    pos = mesh_lib.axes_position(mesh, ("data",))
    x = x[pos * b_loc:(pos + 1) * b_loc].contiguous()
    info["moe_experts_local"] = layer.w_gate.shape[0]
    with torch.no_grad():
        o, aux = path("moe_f32", lambda: moe_lib.moe_fwd(layer, x, spec))
    arrays["moe_o"] = o.cpu().numpy()
    arrays["moe_aux"] = aux.cpu().numpy()
    del layer, x, o
    gc.collect()
    torch.cuda.empty_cache()
    _gpipe(cfg["gpipe"], r.seed, rank, dev, info, path)
    _reshard(cfg["reshard"], wd, dev, info, path)


def _serving(index, docs, queries, r, rank, dev, info, arrays, path) -> None:
    """The engine (drained, then stepped under a clock skewed by rank), the
    router and the row-sharded pinned cache over the round's mesh index."""
    from repro_torch.crypto import rlwe
    from repro_torch.serve import (EngineConfig, ReplicaRouter, RouterConfig,
                                   ServeEngine, SessionManager)

    def sessions():
        return SessionManager(rlwe_params=r.params, deterministic_seeds=True,
                              device=dev)

    def engine(clock=time.monotonic, **kw):
        return ServeEngine(index, config=EngineConfig(max_batch=8, **kw),
                           sessions=sessions(), clock=clock)

    def run(name, srv, **kw):
        got = path(name, lambda: requests(
            srv, queries, docs, r.seed, index.dim, index.num_rows, r.k,
            r.knob, **kw))
        arrays.update({f"{name}_{k}": v for k, v in got.items()})

    eng = engine()
    run("engine_drain", eng)
    eng.close()
    # a clock at another rate and offset on every rank: the deadline fires
    # at other steps unless the first rank decides
    t_zero = time.monotonic()
    eng = engine(clock=lambda: (t_zero + (time.monotonic() - t_zero)
                                * (1.0 + 0.5 * rank) + 100.0 * rank),
                 max_wait_s=WAIT_S)
    run("engine_step", eng, step=True)
    eng.close()
    rt = ReplicaRouter(index, config=RouterConfig(
        num_replicas=REPLICAS, engine=EngineConfig(max_batch=8)),
        sessions=sessions())
    run("router", rt)
    rt.close()
    shard_docs = index.num_rows // NUM_SHARDS
    shard_bytes = (shard_docs * r.params.num_chunks(index.dim)
                   * r.params.num_primes * r.params.n_poly * 4)
    ccfg = rlwe.CandidateCacheConfig(
        num_shards=NUM_SHARDS, async_admission=False,
        max_resident_bytes=PIN_SHARDS * shard_bytes)
    eng = engine(cache_config=ccfg)
    run("engine_sharded", eng)
    cache = index.peek_candidate_cache(r.params, ccfg)
    st = cache.stats()
    info["cache"] = dict(
        placed=cache.placement is not None,
        row_bytes=shard_bytes // shard_docs,
        resident_shards=len(st["resident_shards"]),
        **{k: st[k] for k in ("resident_bytes", "device_resident_bytes",
                              "peak_resident_bytes", "row_parts")})
    eng.close()


def _gpipe(base, seed, rank, dev, info, path) -> None:
    """GPipe over SHAPE named GPIPE_AXES: the float32 model's loss and
    gradients against the same model in this process (one rank at a time
    holds its graph), then a bfloat16 step."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.transformer import Transformer

    mesh = mesh_lib.make_mesh(SHAPE, GPIPE_AXES, device=dev.type,
                              backend="gloo")

    def model(cfg):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return Transformer(cfg, generator=gen, device=dev).requires_grad_(True)

    t = np.random.default_rng(seed).integers(
        0, base.vocab, size=(GPIPE_TOKENS[0], GPIPE_TOKENS[1] + 1))
    t = torch.from_numpy(t).to(dev)
    tokens, targets = t[:, :-1].contiguous(), t[:, 1:].contiguous()
    pcfg = dataclasses.replace(base, n_layers=GPIPE_PARITY_LAYERS,
                               dtype="float32", remat=False)
    m = model(pcfg)
    own = tf._stage_range(pcfg, mesh, "pod")
    ref = {}
    for r in range(WORLD):
        dist.barrier()
        if r == rank:
            loss = m.loss(tokens, targets)
            loss.backward()
            loss_ref = float(loss.detach())
            for name, p in m.named_parameters():
                if not name.startswith("layers.") or int(
                        name.split(".")[1]) in own:
                    ref[name] = p.grad.cpu()
                p.grad = None
            del loss
            torch.cuda.empty_cache()
    dist.barrier()
    tf.pipeline_stage(m, mesh, "pod")

    def parity():
        loss = tf.pipeline_loss(m, tokens, targets, mesh=mesh,
                                n_micro=GPIPE_MICRO)
        loss.backward()
        return float(loss.detach())

    loss = path("gpipe_parity", parity)
    errs = {}
    for name, p in m.named_parameters():
        if name.startswith("layers."):
            i, rest = name[len("layers."):].split(".", 1)
            name = f"layers.{own[int(i)]}.{rest}"
        want = ref.pop(name).to(dev)
        errs[name] = float((p.grad - want).norm() / want.norm())
    info["gpipe"] = dict(loss_rel_err=abs(loss - loss_ref) / abs(loss_ref),
                         grad_rel_err_max=max(errs.values()),
                         missing=sorted(ref))
    del m
    gc.collect()
    torch.cuda.empty_cache()
    m = tf.pipeline_stage(model(dataclasses.replace(
        base, n_layers=GPIPE_LAYERS)), mesh, "pod")

    def step():
        loss = tf.pipeline_loss(m, tokens, targets, mesh=mesh,
                                n_micro=GPIPE_MICRO)
        loss.backward()
        return float(loss.detach())

    info["gpipe"]["bf16_loss"] = path("gpipe_bf16", step)
    del m
    gc.collect()
    torch.cuda.empty_cache()


def _sharded_step(step_fn, full_state, mesh, specs):
    """A one-process run's ``step_fn`` as a step over this rank's slices
    under ``specs``: gather them into ``full_state``, step, keep the new
    state's slices (the arithmetic is the one-process step's on every
    mesh)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint as ckpt

    by_path = ckpt._spec_paths(specs)

    def run(local, batch):
        with torch.no_grad():
            for (p, full), (_, loc) in zip(ckpt._flatten(full_state),
                                           ckpt._flatten(local)):
                full.copy_(mesh_lib.gather_full(loc, mesh, by_path[p]))
        new, metrics = step_fn(full_state, batch)
        return ckpt.shard_state(new, mesh, specs), metrics

    return run


def _reshard(cfg, wd: Path, dev, info, path) -> None:
    """The re-sharding drill: two steps' state saved on SHAPE restored on
    (WORLD,); a run sharded on SHAPE dies at RESHARD_FAIL and resumes on
    (WORLD,); both bit for bit, under deterministic algorithms."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train import optimizer as opt_lib

    a = mesh_lib.make_mesh(SHAPE, AXES, device=dev.type, backend="gloo")
    b = mesh_lib.make_mesh((WORLD,), ("data",), device=dev.type,
                           backend="gloo")

    def specs(axes):
        p = tf.fsdp_param_specs(cfg, axes)
        return p, opt_lib.state_specs(p)

    spec_a, spec_b = specs(AXES), specs(("data",))
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step_fn, batches_fn, full = drill_run(cfg, dev)
        for i in range(2):
            full, _ = step_fn(full, batches_fn(i))

        def save_restore():
            ckpt.save(wd / "reshard_ck", 1, ckpt.shard_state(full, a, spec_a),
                      mesh=a, specs=spec_a)
            example = ckpt.shard_state(full, b, spec_b)
            for t in leaves(example):
                t.zero_()
            return ckpt.restore(wd / "reshard_ck", 1, example, mesh=b,
                                specs=spec_b)

        got = path("reshard_restore", save_restore)
        restored = all(torch.equal(x, y) for x, y in zip(
            leaves(got), leaves(ckpt.shard_state(full, b, spec_b))))
        del full, got
        rr = fault.ResumableRun(str(wd / "reshard_run"),
                                checkpoint_every=RESHARD_EVERY)
        injector = fault.FailureInjector(fail_at_steps=(RESHARD_FAIL,))

        def drill():
            step_fn, batches_fn, state = drill_run(cfg, dev)
            try:
                rr.run(_sharded_step(step_fn, state, a, spec_a),
                       ckpt.shard_state(state, a, spec_a), batches_fn,
                       RESHARD_STEPS, injector=injector, mesh=a,
                       state_specs=spec_a)
                died = False
            except fault.InjectedFailure:
                died = True
            step_fn, batches_fn, state = drill_run(cfg, dev)
            return died, rr.run(_sharded_step(step_fn, state, b, spec_b),
                                ckpt.shard_state(state, b, spec_b),
                                batches_fn, RESHARD_STEPS, injector=injector,
                                mesh=b, state_specs=spec_b)

        died, (resumed, done, _) = path("reshard_drill", drill)
        step_fn, batches_fn, state = drill_run(cfg, dev)
        for i in range(RESHARD_STEPS):
            state, _ = step_fn(state, batches_fn(i))
        same = all(torch.equal(x, y) for x, y in zip(
            leaves(resumed), leaves(ckpt.shard_state(state, b, spec_b))))
    finally:
        torch.use_deterministic_algorithms(was)
    info["reshard"] = dict(restored=restored, died=died, resumed_steps=done,
                           resumed=same)


# -- the module's one run of the ranks -------------------------------------------

def _join(ctx, deadline_s: float) -> None:
    """Wait for the spawned ranks; a rank's exception re-raises here."""
    t_end = time.monotonic() + deadline_s
    while not ctx.join(timeout=1):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {deadline_s} s")


@pytest.fixture(scope="module")
def runs(cuda, tmp_path_factory):
    """The ranks' results beside one process's: the flat scan of the first
    stage, the round and the engine over the round's index, the einsum MoE
    layer, and the drill's checkpoint restored here."""
    from repro_torch.configs import remoterag
    from repro_torch.core import planner
    from repro_torch.data import synth
    from repro_torch.models import moe as moe_lib
    from repro_torch.retrieval.index import FlatIndex
    from repro_torch.retrieval.topk import distributed_topk
    from repro_torch.serve import EngineConfig, ServeEngine, SessionManager
    from repro_torch.serve import batching

    wd = tmp_path_factory.mktemp("mesh")
    if cuda.type == "cuda":
        ext.extension()                 # built once, here
    mtime = so_mtime()
    cfgs = configs()
    dim, k, knob, params = (remoterag.DIM, remoterag.K, remoterag.KPRIME,
                            remoterag.RLWE)
    # the first stage's corpus (normalized rows, read by every rank) and the
    # flat scan of 8 perturbed queries in one process
    corpus = synth.uniform_corpus(np.random.default_rng(0), FIRST_DOCS, dim)
    plan = planner.plan(n=dim, N=FIRST_DOCS, k=k, kprime=knob)
    index = FlatIndex.build(corpus, device=cuda)
    np.save(wd / "corpus.npy", index.embeddings.cpu().numpy())
    queries = synth.queries_near_corpus(np.random.default_rng(1), corpus,
                                        REQUESTS)
    del corpus
    q = batching.perturb_batch(
        [torch.Generator(device=cuda).manual_seed(1000 + j)
         for j in range(REQUESTS)], queries, [plan.eps] * REQUESTS,
        device=cuda)
    np.save(wd / "queries.npy", q.cpu().numpy())
    flat = distributed_topk(index, q, plan.kprime)
    first = (flat.values.cpu().numpy(), flat.indices.cpu().numpy())
    del index, flat
    # the round's corpus: the round and the engine in one process
    rnd = types.SimpleNamespace(seed=0, gen_seed=17, n_docs=ROUND_DOCS,
                                dim=dim, k=k, knob=knob, params=params)
    corpus = synth.uniform_corpus(np.random.default_rng(rnd.seed + 7),
                                  rnd.n_docs, dim)
    r_queries = synth.queries_near_corpus(
        np.random.default_rng(rnd.seed + 8), corpus, REQUESTS)
    docs = [f"passage-{i}".encode() for i in range(rnd.n_docs)]
    index = FlatIndex.build(corpus, documents=docs, device=cuda)
    del corpus
    r_plan = planner.plan(n=dim, N=rnd.n_docs, k=k, kprime=knob)
    single = round_trip(index, docs, r_queries, r_plan, params, rnd.seed,
                        rnd.gen_seed, cuda)
    eng = ServeEngine(index, config=EngineConfig(max_batch=8),
                      sessions=SessionManager(rlwe_params=params,
                                              deterministic_seeds=True,
                                              device=cuda))
    serve = requests(eng, r_queries, docs, rnd.seed, dim, rnd.n_docs, k, knob)
    eng.close()
    del index, eng
    # the MoE layer in one process, one "data" shard at a time (the
    # router's products have the ranks' shapes, so routing is bit-equal)
    layer, x = moe_inputs(cfgs["moe"], rnd.seed, cuda)
    half = x.shape[0] // SHAPE[0]
    with torch.no_grad():
        shards = [moe_lib.moe_fwd_einsum(layer, x[i:i + half], cfgs["moe"])
                  for i in range(0, x.shape[0], half)]
    moe_o = torch.cat([o for o, _ in shards]).cpu().numpy()
    moe_aux = float(sum(a for _, a in shards)) / len(shards)
    del layer, x, shards
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dict(device=cuda.type, kprime=plan.kprime, round=rnd, **cfgs)
    ctx = mp.spawn(_rank_main, args=(str(wd), cfg), nprocs=WORLD, join=False)
    try:
        _join(ctx, RANKS_DEADLINE_S)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    infos = [json.loads((wd / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    arrays = [dict(np.load(wd / f"rank{r}.npz")) for r in range(WORLD)]

    # the drill's checkpoint, saved on SHAPE, restored in one process
    from repro_torch.train import checkpoint as ckpt

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        step_fn, batches_fn, full = drill_run(cfgs["reshard"], cuda)
        for i in range(2):
            full, _ = step_fn(full, batches_fn(i))
        example = ckpt._unflatten(full, iter(
            [torch.zeros_like(t) for t in leaves(full)]))
        got = ckpt.restore(wd / "reshard_ck", 1, example)
        restored_here = all(torch.equal(a, b) for a, b in zip(
            leaves(got), leaves(full)))
    finally:
        torch.use_deterministic_algorithms(was)
    return types.SimpleNamespace(
        mtime=mtime, first=first, single=single, serve=serve, moe_o=moe_o,
        moe_aux=moe_aux, infos=infos, arrays=arrays,
        restored_here=restored_here)


def test_ranks_load_the_parents_kernel_build(runs):
    """Every rank loaded the build the parent made (its mtime unchanged)."""
    assert [i["so_mtime"] for i in runs.infos] == [runs.mtime] * WORLD


def test_mesh_first_stage_equals_flat_scan_on_card(runs):
    """The first stage over both axes (a quarter of the 10^6 rows a rank)
    equals the flat scan in one process bit for bit on every rank."""
    for info, arr in zip(runs.infos, runs.arrays):
        assert info["first_rows"] == [FIRST_DOCS, FIRST_DOCS // WORLD]
        np.testing.assert_array_equal(arr["first_v"], runs.first[0])
        np.testing.assert_array_equal(arr["first_i"], runs.first[1])
        serving.assert_launched(info["first_stage"], ("score_topk",))


def test_mesh_round_equals_one_process_on_card(runs):
    """The round one request at a time and as one batch over the mesh
    index: every rank's ids, wire bytes, documents, candidates and
    decrypted scores equal one process's."""
    for info, arr in zip(runs.infos, runs.arrays):
        for key, want in runs.single.items():
            np.testing.assert_array_equal(arr[f"round_{key}"], want, key)
        assert all(bool(v) for k, v in runs.single.items()
                   if k.startswith("docs_ok"))
        serving.assert_launched(info["round"])


def test_mesh_engine_router_and_row_sharded_cache_on_card(runs):
    """Over the round's mesh index the engine (drained; stepped under
    skewed clocks, in the same batches on every rank), the router and the
    row-sharded pinned cache serve every request with the documents of its
    ids and one process's ids, wire bytes and request ids (the engines:
    and decrypted scores); each rank holds 1/4 of the resident shards."""
    single = runs.serve
    assert single["ok"].all()
    sizes = runs.arrays[0]["engine_step_sizes"]
    for info, arr in zip(runs.infos, runs.arrays):
        for run in SERVING_PATHS:
            assert arr[f"{run}_ok"].all(), run
            for key in ("ids", "bytes", "rids"):
                np.testing.assert_array_equal(arr[f"{run}_{key}"],
                                              single[key], f"{run} {key}")
            if run != "router":
                np.testing.assert_array_equal(arr[f"{run}_scores"],
                                              single["scores"], run)
            serving.assert_launched(info[run])
        np.testing.assert_array_equal(arr["engine_step_sizes"], sizes)
        c = info["cache"]
        assert c["placed"] and c["row_parts"] == WORLD, c
        assert c["resident_shards"] >= 2, c
        assert c["device_resident_bytes"] * WORLD == c["resident_bytes"], c
        assert (c["device_resident_bytes"]
                <= c["peak_resident_bytes"] / WORLD + c["row_bytes"]), c


def test_mesh_moe_layer_equals_einsum_on_card(runs):
    """The expert-parallel MoE layer (float32) within 1e-5 of the einsum
    layer in one process, relative to its largest output; aux within 1e-5
    relative; no kernel of ours launched."""
    half = MOE_TOKENS[0] // SHAPE[0]
    scale = float(np.abs(runs.moe_o).max())
    for r, (info, arr) in enumerate(zip(runs.infos, runs.arrays)):
        pos = r // SHAPE[1]                 # the rank's "data" position
        want = runs.moe_o[pos * half:(pos + 1) * half]
        assert float(np.abs(arr["moe_o"] - want).max()) <= 1e-5 * scale
        assert abs(float(arr["moe_aux"]) - runs.moe_aux) <= 1e-5 * abs(
            runs.moe_aux)
        assert info["moe_f32"] == {}


def test_mesh_gpipe_equals_one_process_on_card(runs):
    """GPipe's float32 loss within 1e-5 and every gradient of the rank's
    stage within 1e-4 normwise of one process; the bfloat16 step's loss
    finite; no kernel of ours launched."""
    for info in runs.infos:
        g = info["gpipe"]
        assert not g["missing"], g["missing"][:3]
        assert g["loss_rel_err"] <= LOSS_RTOL, g
        assert g["grad_rel_err_max"] <= GRAD_RTOL, g
        assert np.isfinite(g["bf16_loss"])
        assert info["gpipe_parity"] == info["gpipe_bf16"] == {}


def test_mesh_reshard_drill_bit_for_bit_on_card(runs):
    """The checkpoint saved on (2, 2) restores on (4,) and in one process
    bit for bit; the run that died on (2, 2) at step 2 resumes on (4,) to
    the uninterrupted run's state; no kernel of ours launched."""
    assert runs.restored_here
    for info in runs.infos:
        d = info["reshard"]
        assert d["restored"] and d["died"] and d["resumed"], d
        assert d["resumed_steps"] == RESHARD_STEPS - RESHARD_FAIL, d
        assert info["reshard_restore"] == info["reshard_drill"] == {}
