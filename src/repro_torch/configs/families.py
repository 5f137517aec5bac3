"""Dry-run cells per architecture family (counterpart of
``repro/configs/families.py``).

A `Cell` is everything `repro_torch.launch.dryrun` needs for one (arch x
shape x mesh): the step function, its inputs as ``meta`` tensors (the
reference's ``ShapeDtypeStruct``s), the placement of every input and
output as `launch.mesh.ShardSpec` trees, and the donation hints.  The mesh
is a shape and axis names (`MeshShape`, from
`launch.mesh.production_mesh_shape`): building a cell starts no process
group and allocates no device memory.

The parameters of a model cell are a ``meta`` model's own parameters
(``requires_grad`` on), as the port's trainer takes them
(`train.trainer.make_train_step`: the loss reads the module, the
optimizer updates the dict's tensors in place); ``fn`` runs on them and on
the other ``meta`` inputs.  A cell whose step runs collectives (the
``moe_a2a`` and ``pp2`` variants, the module-1 sharded search) records
``mesh_fn``: given a live mesh (`launch.mesh.make_mesh`) it returns that
step, and ``fn`` is its one-process equivalent, the same arithmetic
(the einsum MoE, ``Transformer.loss``, one top-k over the whole corpus).

Variants map onto the port's functions: ``fsdp_only`` / ``fsdp_noremat``
onto `transformer.fsdp_param_specs`, ``tp_repl`` onto `param_specs` with
the "data" entries stripped, ``pp2`` onto `transformer.pipeline_loss`
(the layers of stage s live on the ranks at position s of "pod":
``Cell.stage_axis``), ``moe_a2a`` onto the ``shard_a2a`` MoE, the
two-tower ``bf16`` variant and the module-1 ``big`` / ``bf16`` /
``ptk32`` variants onto their configs and `retrieval.topk.make_sharded_topk`;
module 2's encrypted scoring is the plain per-prime NTT path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.configs import shapes as shp
from repro_torch.crypto import modring
from repro_torch.crypto import rlwe
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.launch.mesh import (ShardSpec, batch_axes,
                                     production_mesh_shape, row_axes)
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.retrieval.topk import make_sharded_topk
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer as trainer_lib

_S = ShardSpec.of


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as a shape and axis names, with no ranks behind it
    (`launch.mesh.batch_axes` and `row_axes` read its names)."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axes_size(self, axes) -> int:
        """Ranks along ``axes`` (names, or one name)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[self.mesh_dim_names.index(a)]
                         for a in axes)


def production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """`launch.mesh.production_mesh_shape` as a `MeshShape`."""
    return MeshShape(*production_mesh_shape(multi_pod=multi_pod))


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable                  # the step on tensors, in one process
    args: tuple                   # trees of meta tensors
    in_shardings: tuple           # the same trees of ShardSpec
    out_shardings: object = None  # None: the reference leaves it to GSPMD
    donate_argnums: tuple = ()    # recorded hint; eager PyTorch donates none
    mesh_fn: Optional[Callable] = None   # live mesh -> the collective step
    stage_axis: Optional[str] = None     # pp2: "layers.*" split by stage


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_params(model: torch.nn.Module) -> dict:
    return dict(model.requires_grad_(True).named_parameters())


OPT_CFG = opt_lib.AdamWConfig()


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _strip(spec: ShardSpec, axis: str) -> ShardSpec:
    return ShardSpec(tuple(tuple(a for a in d if a != axis)
                           for d in spec.dims))


def lm_cell(cfg: tf_lib.TransformerConfig, shape: shp.LmShape,
            mesh: MeshShape, *, roofline: bool = False,
            scan_knob: Optional[int] = None,
            variant: Optional[str] = None) -> Cell:
    """variant: None | "moe_a2a" | "tp_repl" | "micro2" | "micro16" |
    "fsdp_only" | "fsdp_noremat" | "pp2" (the reference's hillclimb
    configurations)."""
    ba = batch_axes(mesh)
    cfg = dataclasses.replace(
        cfg, batch_axes=ba,
        n_layers=scan_knob if scan_knob else cfg.n_layers,
        scan_unroll=cfg.n_layers if roofline and not scan_knob else 1)
    if variant == "moe_a2a" and cfg.is_moe:
        # the expert-parallel MoE; with no mesh it runs the einsum path,
        # the same arithmetic in one process
        cfg = dataclasses.replace(cfg, moe_impl="shard_a2a")
    if variant in ("fsdp_only", "fsdp_noremat"):
        all_axes = tuple(mesh.mesh_dim_names)
        cfg = dataclasses.replace(cfg, tp=1, batch_axes=all_axes,
                                  tp_axis=None,
                                  remat=variant != "fsdp_noremat")
        ba = all_axes
    pspec = (tf_lib.fsdp_param_specs(cfg, tuple(mesh.mesh_dim_names))
             if variant in ("fsdp_only", "fsdp_noremat")
             else tf_lib.param_specs(cfg))
    opt_pspec = pspec
    if variant == "tp_repl":
        # pure-TP weights (replicated over "data"), ZeRO-1 optimizer state
        pspec = {k: _strip(s, "data") for k, s in pspec.items()}
    pp2 = variant == "pp2" and "pod" in mesh.mesh_dim_names
    if pp2:
        # layers over "pod" (GPipe stages), batch within-pod over "data"
        cfg = dataclasses.replace(cfg, batch_axes=("data",))
        ba = ("data",)
        pspec = opt_pspec = tf_lib.param_specs(cfg)

    if shape.kind == "train":
        model = tf_lib.Transformer(cfg, device="meta")
        params = _train_params(model)
        opt = opt_lib.abstract_init(params, OPT_CFG)
        opt_spec = opt_lib.state_specs(opt_pspec)
        tok = _meta((shape.global_batch, shape.seq_len), torch.int32)
        batch_spec = (_S(ba, None), _S(ba, None))
        micro = {"micro2": 2, "micro16": 16, "pp2": 1}.get(variant, 8)
        micro = 1 if roofline else micro

        def step_of(loss):
            return trainer_lib.make_train_step(
                loss, OPT_CFG, param_dtype=cfg.torch_dtype,
                microbatches=micro)

        mesh_fn = None
        if pp2:
            def mesh_fn(live):
                return step_of(lambda p, t, y: tf_lib.pipeline_loss(
                    model, t, y, mesh=live, n_micro=8))
        elif cfg.moe_impl == "shard_a2a":
            def mesh_fn(live):
                # puts the model's MoE layers on the live mesh (fn too)
                for blk in model.layers:
                    blk.moe.spec = dataclasses.replace(blk.moe.spec,
                                                       mesh=live)
                return step_of(lambda p, t, y: model.loss(t, y))

        return Cell(
            arch=cfg.name, shape=shape.name,
            fn=step_of(lambda p, t, y: model.loss(t, y)),
            args=(params, opt, (tok, tok)),
            in_shardings=(pspec, opt_spec, batch_spec),
            out_shardings=(pspec, opt_spec,
                           {"loss": _S(), "grad_norm": _S(), "lr": _S()}),
            donate_argnums=(0, 1), mesh_fn=mesh_fn,
            stage_axis="pod" if pp2 else None)

    if shape.kind == "prefill":
        model = tf_lib.Transformer(cfg, device="meta")
        tok = _meta((shape.global_batch, shape.seq_len), torch.int32)
        kv_spec = _S(None, ba, None, "model", None)
        cache_spec = {"k": kv_spec, "v": kv_spec, "len": _S()}

        def prefill_step(p, tokens):
            logits, cache = model.prefill(tokens, shape.seq_len)
            return logits[:, -1, :], cache

        return Cell(
            arch=cfg.name, shape=shape.name, fn=prefill_step,
            args=(dict(model.named_parameters()), tok),
            in_shardings=(pspec, _S(ba, None)),
            out_shardings=(_S(ba, "model"), cache_spec))

    # decode: one token against a seq_len KV cache (+headroom), the UNPADDED
    # config (tp=1) with the serving layout, as the reference
    cfg = dataclasses.replace(cfg, tp=1)
    pspec = tf_lib.decode_param_specs(cfg)
    model = tf_lib.Transformer(cfg, device="meta")
    max_len = shape.seq_len + 1024
    tok = _meta((shape.global_batch, 1), torch.int32)
    cache = model.init_cache(shape.global_batch, max_len)
    cache["len"] = _meta((), torch.int32)
    if shape.global_batch % mesh.axes_size(ba) == 0:
        kv_spec = _S(None, ba, None, None, "model")     # batch x d_head
        tok_spec = _S(ba, None)
        out_logit_spec = _S(ba, "model")
    else:
        # long_500k (batch=1): the cache's SEQUENCE over the data axes
        kv_spec = _S(None, None, ba, None, "model")
        tok_spec = _S(None, None)
        out_logit_spec = _S(None, "model")
    cache_spec = {"k": kv_spec, "v": kv_spec, "len": _S()}

    def decode(p, tokens, cache):
        # the cache holds seq_len tokens: decode at that position
        return model.decode_step(tokens, {**cache, "len": shape.seq_len})

    return Cell(
        arch=cfg.name, shape=shape.name, fn=decode,
        args=(dict(model.named_parameters()), tok, cache),
        in_shardings=(pspec, tok_spec, cache_spec),
        out_shardings=(out_logit_spec, cache_spec),
        donate_argnums=(2,))


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def gnn_cell(cfg: gnn_lib.GnnConfig, shape: shp.GraphShape,
             mesh: MeshShape, *, roofline: bool = False,
             scan_knob: Optional[int] = None,
             variant: Optional[str] = None) -> Cell:
    # graphs have no TP dim: nodes/edges shard over EVERY mesh axis
    ba = row_axes(mesh)
    cfg = dataclasses.replace(
        cfg, d_feat=shape.d_feat,
        n_layers=scan_knob if scan_knob else cfg.n_layers,
        scan_unroll=cfg.n_layers if roofline and not scan_knob else 1)
    model = gnn_lib.Gnn(cfg, device="meta")
    params = _train_params(model)
    pspec = {k: _S() for k in params}                 # replicated (small)
    opt = opt_lib.abstract_init(params, OPT_CFG)
    opt_spec = opt_lib.state_specs(pspec)
    batch = gnn_lib.GraphBatch(
        node_feats=_meta((shape.n_nodes, shape.d_feat), torch.float32),
        edge_src=_meta((shape.n_edges,), torch.int32),
        edge_dst=_meta((shape.n_edges,), torch.int32),
        targets=_meta((shape.n_nodes, cfg.n_vars), torch.float32))
    batch_spec = gnn_lib.GraphBatch(
        node_feats=_S(ba, None), edge_src=_S(ba), edge_dst=_S(ba),
        targets=_S(ba, None))

    def loss(p, node_feats, edge_src, edge_dst, targets):
        return model.loss(gnn_lib.GraphBatch(node_feats, edge_src, edge_dst,
                                             targets))

    step = trainer_lib.make_train_step(loss, OPT_CFG,
                                       param_dtype=cfg.torch_dtype)
    return Cell(arch=cfg.name, shape=shape.name, fn=step,
                args=(params, opt, tuple(batch)),
                in_shardings=(pspec, opt_spec, tuple(batch_spec)),
                donate_argnums=(0, 1))


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------

def _recsys_batch(arch: str, cfg, b: int) -> tuple:
    """(meta tree, spec tree) of ``arch``'s batch of ``b``, labels last;
    ``("data",)`` in a spec stands for the mesh's batch axes."""
    d = ("data",)
    if arch == "fm":
        return ((_meta((b, cfg.n_sparse), torch.int32),
                 _meta((b,), torch.float32)), (_S(d, None), _S(d)))
    if arch == "dcn-v2":
        return ((_meta((b, cfg.n_dense), torch.float32),
                 _meta((b, cfg.n_sparse), torch.int32),
                 _meta((b,), torch.float32)),
                (_S(d, None), _S(d, None), _S(d)))
    if arch == "dien":
        return ((_meta((b, cfg.seq_len), torch.int32),
                 _meta((b,), torch.int32), _meta((b,), torch.float32)),
                (_S(d, None), _S(d), _S(d)))
    if arch == "two-tower-retrieval":
        return ((_meta((b, cfg.n_user_feats), torch.int32),
                 _meta((b, cfg.n_item_feats), torch.int32)),
                (_S(d, None), _S(d, None)))
    raise KeyError(arch)


def _recsys_pspec(params: dict) -> dict:
    """Row-shard every large table over 'model'; replicate small MLPs."""
    return {name: (_S("model", None) if "table" in name or "linear" in name
                   else _S(*([None] * p.dim())))
            for name, p in params.items()}


def recsys_cell(arch: str, cfg, shape: shp.RecsysShape, mesh: MeshShape,
                *, roofline: bool = False,
                scan_knob: Optional[int] = None,
                variant: Optional[str] = None) -> Cell:
    if arch == "two-tower-retrieval" and variant == "bf16":
        cfg = dataclasses.replace(cfg, dtype="bfloat16")
    ba = batch_axes(mesh)
    if arch == "dien" and roofline:
        cfg = dataclasses.replace(cfg, unroll=cfg.seq_len)
    # the model's ``loss`` and ``forward`` are the reference's
    # ``_recsys_batch`` loss and ``_recsys_forward``
    model = rec_lib.MODELS[arch](cfg, device="meta")
    pspec = _recsys_pspec(dict(model.named_parameters()))
    fwd = lambda p, *inputs: model(*inputs)

    def fix_ba(spec: ShardSpec) -> ShardSpec:  # ("data",) -> batch axes
        return ShardSpec(tuple(ba if d == ("data",) else d
                               for d in spec.dims))

    if shape.kind == "train":
        params = _train_params(model)
        batch, batch_spec = _recsys_batch(arch, cfg, shape.batch)
        batch_spec = tuple(fix_ba(s) for s in batch_spec)
        opt = opt_lib.abstract_init(params, OPT_CFG)
        opt_spec = opt_lib.state_specs(pspec)
        step = trainer_lib.make_train_step(
            lambda p, *leaves: model.loss(*leaves), OPT_CFG,
            param_dtype=cfg.torch_dtype)
        return Cell(arch=arch, shape=shape.name, fn=step,
                    args=(params, opt, batch),
                    in_shardings=(pspec, opt_spec, batch_spec),
                    donate_argnums=(0, 1))

    params = dict(model.named_parameters())
    if shape.kind == "serve":
        batch, batch_spec = _recsys_batch(arch, cfg, shape.batch)
        if arch != "two-tower-retrieval":
            batch = batch[:-1]                   # no labels
        batch_spec = tuple(fix_ba(s) for s in batch_spec)[:len(batch)]
        return Cell(arch=arch, shape=shape.name, fn=fwd,
                    args=(params,) + tuple(batch),
                    in_shardings=(pspec,) + batch_spec)

    # retrieval: 1 query vs n_candidates (padded to shard evenly)
    ra = row_axes(mesh)
    n_shards = mesh.axes_size(ra)
    c = -(-shape.n_candidates // n_shards) * n_shards
    if arch == "two-tower-retrieval":
        uf = _meta((shape.batch, cfg.n_user_feats), torch.int32)
        cands = _meta((c, cfg.tower_mlp[-1]), torch.float32)
        return Cell(arch=arch, shape=shape.name,
                    fn=lambda p, u, cand: model.score_candidates(u, cand),
                    args=(params, uf, cands),
                    in_shardings=(pspec, _S(None, None), _S(ra, None)))
    # ranking archs: bulk-score c candidates for one user context
    if arch == "dien":
        hist = _meta((1, cfg.seq_len), torch.int32)
        tgt = _meta((c,), torch.int32)
        return Cell(arch=arch, shape=shape.name,
                    fn=lambda p, h, t: model(h.expand(c, cfg.seq_len), t),
                    args=(params, hist, tgt),
                    in_shardings=(pspec, _S(None, None), _S(ra)))
    if arch == "fm":
        return Cell(arch=arch, shape=shape.name, fn=fwd,
                    args=(params, _meta((c, cfg.n_sparse), torch.int32)),
                    in_shardings=(pspec, _S(ra, None)))
    return Cell(arch=arch, shape=shape.name, fn=fwd,          # dcn-v2
                args=(params, _meta((c, cfg.n_dense), torch.float32),
                      _meta((c, cfg.n_sparse), torch.int32)),
                in_shardings=(pspec, _S(ra, None), _S(ra, None)))


# ---------------------------------------------------------------------------
# remoterag (the paper's own service steps)
# ---------------------------------------------------------------------------

def remoterag_cell(shape: shp.RagShape, mesh: MeshShape,
                   params: Optional[rlwe.RlweParams] = None,
                   *, roofline: bool = False,
                   scan_knob: Optional[int] = None,
                   variant: Optional[str] = None) -> Cell:
    dtype = torch.float32
    per_tile_k = None
    if shape.kind == "module1" and variant:
        if "big" in variant:  # serving-scale stress: 64M docs, 256 queries
            shape = dataclasses.replace(shape, corpus=2 ** 26, batch=256)
        if "bf16" in variant:
            dtype = torch.bfloat16
        if "ptk32" in variant:  # certificate-checked reduced local top-k
            per_tile_k = 32
    params = params or rlwe.RlweParams()
    ra = row_axes(mesh)
    ba = batch_axes(mesh)
    if shape.kind == "module1":
        corpus = _meta((shape.corpus, shape.dim), dtype)
        queries = _meta((shape.batch, shape.dim), dtype)
        kprime = shape.kprime

        def one_process(q, c):
            # the whole corpus's scores and top-k' in one process: the
            # sharded search's arithmetic (its blocks' scans, then a merge)
            return tuple(torch.topk(torch.matmul(q.float(), c.float().T),
                                    kprime, dim=-1))

        def mesh_fn(live):
            search = make_sharded_topk(live, ra, shape.corpus, kprime,
                                       per_tile_k=per_tile_k)
            return lambda q, c: tuple(search(q, c))[:2]

        return Cell(arch="remoterag", shape=shape.name, fn=one_process,
                    args=(queries, corpus),
                    in_shardings=(_S(None, None), _S(ra, None)),
                    mesh_fn=mesh_fn)
    # module 2a: batched encrypted re-ranking over R requests
    chunks = params.num_chunks(shape.dim)
    cpt = params.cands_per_ct(shape.dim)
    num_ct = -(-shape.kprime // cpt)
    r = shape.batch
    c0 = _meta((r, chunks, params.num_primes, params.n_poly), torch.int32)
    packed = _meta((r, num_ct, chunks, params.num_primes, params.n_poly),
                   torch.int32)

    def enc_scores(c0_, c1_, packed_):
        # the plain per-prime path, batched over (R, num_ct)
        outs0, outs1 = [], []
        for i, ctx in enumerate(params.ctxs):
            f0 = ntt_ops.ntt_fwd(c0_[:, :, i, :], ctx)
            f1 = ntt_ops.ntt_fwd(c1_[:, :, i, :], ctx)
            pk = packed_[:, :, :, i, :]                  # (R, CT, CH, N)
            p0 = modring.mod_mul(pk, f0[:, None, :, :], ctx.q, ctx.mu)
            p1 = modring.mod_mul(pk, f1[:, None, :, :], ctx.q, ctx.mu)
            a0, a1 = p0[:, :, 0, :], p1[:, :, 0, :]
            for ch in range(1, chunks):
                a0 = modring.mod_add(a0, p0[:, :, ch, :], ctx.q)
                a1 = modring.mod_add(a1, p1[:, :, ch, :], ctx.q)
            outs0.append(ntt_ops.ntt_inv(a0.to(torch.int32), ctx))
            outs1.append(ntt_ops.ntt_inv(a1.to(torch.int32), ctx))
        return torch.stack(outs0, 2), torch.stack(outs1, 2)

    return Cell(arch="remoterag", shape=shape.name, fn=enc_scores,
                args=(c0, c0, packed),
                in_shardings=(_S(ba, None, None, None),
                              _S(ba, None, None, None),
                              _S(ba, None, None, None, None)))


__all__ = ["MeshShape", "production_mesh", "Cell",
           "lm_cell", "gnn_cell", "recsys_cell", "remoterag_cell", "OPT_CFG"]
