"""The port's sharding specs, abstract parameters and optimizer state
against the JAX package's, and `shard_params` over a real mesh.

For each of the five LM configs (full size; nothing is allocated),
``param_specs``, ``decode_param_specs``, ``fsdp_param_specs`` and
``cache_specs`` equal the reference's trees mapped onto the port's names
by `repro_torch.convert.param_specs` (the stacked-layer entry dropped);
``abstract_params`` and ``optimizer.abstract_init`` have the reference's
shapes (per layer) and dtypes.  Then four ``gloo`` ranks on a (2, 2)
``("data", "model")`` mesh (spawned once for the module, a ``FileStore``
rendezvous, one intra-op thread each) cut two reduced models with each
layout and all-gather the slices back: they reassemble to the full
parameters bit for bit.  JAX is imported inside the fixtures only, so the
spawned ranks load none of it.
"""

import dataclasses
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import ShardSpec
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt

WORLD = 4
LM_ARCHS = ["llama3-8b", "qwen3-8b", "qwen2.5-14b", "qwen3-moe-30b-a3b",
            "granite-moe-3b-a800m"]
# reduced configs at tp = 2 whose every dimension splits over the mesh
SHARD_ARCHS = ["qwen3-moe-30b-a3b", "qwen2.5-14b"]
LAYOUTS = ("param", "decode", "fsdp", "expert")
# (arch, layout): the expert-parallel layout only for the MoE config
SHARD_CASES = [(a, lay) for a in SHARD_ARCHS for lay in LAYOUTS
               if lay != "expert" or a == "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module")
def jref():
    """The reference's transformer, optimizer and registry modules."""
    from repro.configs import registry as jreg
    from repro.models import transformer as jt
    from repro.train import optimizer as jopt

    return types.SimpleNamespace(reg=jreg, t=jt, opt=jopt)


def _cfgs(jref, arch):
    return jref.reg.get(arch).config, treg.get(arch).config


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_equal_reference(jref, arch):
    jcfg, cfg = _cfgs(jref, arch)
    jt = jref.t
    assert tt.param_specs(cfg) == convert.param_specs(jt.param_specs(jcfg),
                                                      cfg)
    assert tt.param_specs(cfg, fsdp_axis="pod", tp_axis="data") == \
        convert.param_specs(jt.param_specs(jcfg, fsdp_axis="pod",
                                           tp_axis="data"), cfg)
    assert tt.decode_param_specs(cfg) == convert.param_specs(
        jt.decode_param_specs(jcfg), cfg)
    assert tt.fsdp_param_specs(cfg) == convert.param_specs(
        jt.fsdp_param_specs(jcfg), cfg)
    assert tt.fsdp_param_specs(cfg, axes=("pod", "data", "model")) == \
        convert.param_specs(jt.fsdp_param_specs(
            jcfg, axes=("pod", "data", "model")), cfg)
    for kw in ({}, dict(batch_axes=("pod", "data"), tp_axis="model")):
        want = {k: convert.shard_spec(v)
                for k, v in jt.cache_specs(jcfg, **kw).items()}
        assert tt.cache_specs(cfg, **kw) == want
    assert set(tt.param_specs(cfg)) == set(tt.abstract_params(cfg))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_params_and_state_equal_reference(jref, arch):
    jcfg, cfg = _cfgs(jref, arch)
    jt, jopt = jref.t, jref.opt
    ref = {k: (tuple(v.shape), str(v.dtype))
           for k, v in _leaves(jt.abstract_params(jcfg)).items()}
    got = tt.abstract_params(cfg)
    per_layer = {}
    for name, (shape, dtype) in ref.items():
        if name.startswith("layers."):
            assert shape[0] == cfg.n_layers, name
            for i in range(cfg.n_layers):
                per_layer[f"layers.{i}.{name[7:]}"] = (shape[1:], dtype)
        else:
            per_layer[name] = (shape, dtype)
    assert set(got) == set(per_layer)
    for name, t in got.items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), str(t.dtype)) == (
            per_layer[name][0], f"torch.{per_layer[name][1]}"), name

    jstate = jopt.abstract_init(jt.abstract_params(jcfg), jopt.AdamWConfig())
    state = topt.abstract_init(got, topt.AdamWConfig())
    assert (tuple(state.step.shape), state.step.dtype) == \
        (tuple(jstate.step.shape), torch.int32)
    for part in ("master", "m", "v"):
        for name, t in getattr(state, part).items():
            assert t.device.type == "meta" and t.dtype == torch.float32
            assert tuple(t.shape) == per_layer[name][0], (part, name)
    jspecs = jopt.state_specs(jt.param_specs(jcfg))
    specs = topt.state_specs(tt.param_specs(cfg))
    assert specs.step == convert.shard_spec(jspecs.step) == ShardSpec.of()
    for part in ("master", "m", "v"):
        assert getattr(specs, part) == convert.param_specs(
            getattr(jspecs, part), cfg)


def _leaves(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves under dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_abstract_params_match_a_real_model():
    for arch in SHARD_ARCHS:
        cfg = _shard_cfg(arch)
        state = tt.Transformer(cfg, generator=torch.Generator().manual_seed(0),
                               device="cpu").state_dict()
        meta = tt.abstract_params(cfg)
        assert list(meta) == list(state)
        for name, t in meta.items():
            assert t.shape == state[name].shape and t.dtype == \
                state[name].dtype, name


def test_expert_parallel_specs_split_only_experts():
    cfg = _shard_cfg("qwen3-moe-30b-a3b")
    specs = tt.expert_parallel_specs(cfg)
    split = {k for k, v in specs.items() if any(v.dims)}
    assert split == {f"layers.{i}.moe.{w}" for i in range(cfg.n_layers)
                     for w in ("w_gate", "w_up", "w_down")}
    assert all(specs[k] == ShardSpec.of("model") for k in split)


def _shard_cfg(arch) -> tt.TransformerConfig:
    return dataclasses.replace(treg.get(arch).reduced, tp=2)


def _layout(cfg, name) -> dict:
    return {"param": tt.param_specs, "decode": tt.decode_param_specs,
            "fsdp": tt.fsdp_param_specs,
            "expert": tt.expert_parallel_specs}[name](cfg)


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    out = {}
    mesh_lib.init_ranks("gloo", store_path=d / "store", rank=rank,
                        world_size=WORLD, timeout_s=120)
    try:
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu",
                                  backend="gloo")
        for arch, name in SHARD_CASES:
            cfg = _shard_cfg(arch)
            full = lambda: tt.Transformer(
                cfg, generator=torch.Generator().manual_seed(3), device="cpu")
            want = full().state_dict()
            specs = _layout(cfg, name)
            model = tt.shard_params(full(), mesh, specs)
            local = dict(model.named_parameters())
            same = all(torch.equal(mesh_lib.gather_full(
                local[k].detach(), mesh, specs[k]), want[k]) for k in want)
            elems = sum(t.numel() for t in local.values())
            out[f"{arch}_{name}"] = np.array([same, elems])
    finally:
        mesh_lib.shutdown()
    np.savez(d / f"rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
    t_end = time.monotonic() + 240
    while not ctx.join(timeout=1):
        if time.monotonic() > t_end:
            for p in ctx.processes:
                p.kill()
            pytest.fail("ranks still running after 240 s")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("arch,layout", SHARD_CASES)
def test_shard_params_reassemble_to_full(shards, arch, layout):
    cfg = _shard_cfg(arch)
    total = sum(t.numel() for t in tt.abstract_params(cfg).values())
    specs = _layout(cfg, layout)
    # elements a rank holds: each parameter over the ranks splitting it
    want = sum(t.numel() // mesh_count(specs[k]) for k, t in
               tt.abstract_params(cfg).items())
    for out in shards:
        same, elems = out[f"{arch}_{layout}"]
        assert bool(same)
        assert int(elems) == want < total


def mesh_count(spec: ShardSpec) -> int:
    sizes = {"data": 2, "model": 2}
    return int(np.prod([sizes[a] for axes in spec.dims for a in axes]))
