"""Checkpoint re-sharding on restore, the port against the JAX package's,
on the CPU.

The port's ranks are four ``gloo`` processes, spawned once for the module
(one intra-op thread each, collectives timing out after 60 s).  They save
a small LM's training state (parameters and AdamW state, after two steps)
on mesh (2, 2) ("data", "model") under ``fsdp_param_specs`` and
``optimizer.state_specs``, and restore it on mesh (4,) ("data",), on
(2, 2) with the axes swapped, and in one process: every leaf bit for bit.
A `ResumableRun` whose state is sharded on (2, 2) dies at a step and
resumes on (4,), bit for bit equal to an uninterrupted run (each step
gathers the state, runs the one-process step and keeps the rank's
slices, so the arithmetic is the same on every mesh).  The reference runs
once in a subprocess with 8 virtual CPU devices and Auto mesh axes: it
restores a tree with ``restore(..., shardings=)`` on (2, 2) and on (4,),
and each rank's slice must equal the reference's addressable shard at the
rank's mesh coordinates.  This module imports no JAX.
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
import torch.multiprocessing as mp

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import ShardSpec
from repro_torch.launch.train import make_lm_run
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault
from repro_torch.train import optimizer as opt_lib

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CFG = tf.TransformerConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                           n_kv_heads=2, d_ff=64, vocab=256, d_head=8,
                           dtype="float32", remat=False, kv_chunk=16)
RUN = dict(batch=2, seq=16, lr=3e-3, steps=6)
# the reference-shard tree: (shape, spec on (2, 2), spec on (4,))
TREE = {"w": ((8, 6), (("data", "model"), None), ("data", None)),
        "b": ((4, 8), (None, "model"), (None, "data")),
        "m": ((8, 8), ("data", "model"), ("data", None)),
        "s": ((), (), ())}
MESHES = {"2x2": ((2, 2), ("data", "model")), "4": ((4,), ("data",))}

REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.train import checkpoint

tree = dict(np.load(sys.argv[1]))
specs = json.loads(sys.argv[3])
checkpoint.save(sys.argv[4], 7, tree)
out = {}
for tag, (shape, axes, col) in specs.items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))
    sh = {k: NamedSharding(mesh, P(*[tuple(e) if isinstance(e, list) else e
                                     for e in entries]))
          for k, entries in col.items()}
    got = checkpoint.restore(sys.argv[4], 7, tree, shardings=sh)
    for k, arr in got.items():
        for shard in arr.addressable_shards:
            coords = np.argwhere(mesh.devices == shard.device)[0]
            out[f"{tag}_{k}_" + "_".join(map(str, coords))] = np.asarray(
                shard.data)
np.savez(sys.argv[2], **out)
"""


def _full_state():
    """A tiny LM's (params, opt_state) after two AdamW steps, one process."""
    step_fn, batches_fn, state = make_lm_run(CFG, device="cpu", **RUN)
    for i in range(2):
        state, _ = step_fn(state, batches_fn(i))
    return state


def _specs(axes: tuple):
    param = tf.fsdp_param_specs(CFG, axes)
    return (param, opt_lib.state_specs(param))


def _leaves(state) -> list:
    return [leaf for _, leaf in ckpt._flatten(state)]


def _shard(state, mesh, specs):
    return ckpt.shard_state(state, mesh, specs)


def _sharded_step(step_fn, full_state, mesh, specs):
    """``step_fn`` of a one-process run as a step over this rank's slices:
    gather them into ``full_state``, step, keep the new state's slices
    (collective), so the arithmetic is the one-process step's on every
    mesh."""
    by_path = ckpt._spec_paths(specs)

    def run(local, batch):
        with torch.no_grad():
            for (path, full), (_, loc) in zip(ckpt._flatten(full_state),
                                              ckpt._flatten(local)):
                full.copy_(mesh_lib.gather_full(loc, mesh, by_path[path]))
        new, metrics = step_fn(full_state, batch)
        return _shard(new, mesh, specs), metrics

    return run


def _coords(mesh) -> str:
    return "_".join(str(mesh.get_local_rank(d))
                    for d in range(mesh.mesh.ndim))


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    out = {}
    full = _full_state()
    mesh_lib.init_ranks("gloo", store_path=d / "store", rank=rank,
                        world_size=WORLD, timeout_s=60)
    try:
        a = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu",
                               backend="gloo")
        b = mesh_lib.make_mesh((4,), ("data",), device="cpu", backend="gloo")
        c = mesh_lib.make_mesh((2, 2), ("model", "data"), device="cpu",
                               backend="gloo")
        spec_a, spec_b = _specs(("data", "model")), _specs(("data",))
        ckpt.save(d / "ck", 5, _shard(full, a, spec_a), mesh=a, specs=spec_a)
        for tag, mesh, specs in (("b", b, spec_b), ("c", c, spec_a)):
            want = _shard(full, mesh, specs)
            example = _shard(full, mesh, specs)
            for leaf in _leaves(example):
                leaf.zero_()
            got = ckpt.restore(d / "ck", 5, example, mesh=mesh, specs=specs)
            out[f"{tag}_equal"] = np.array(all(
                torch.equal(x, y) for x, y in zip(_leaves(got),
                                                  _leaves(want))))
            out[f"{tag}_sliced"] = np.array(any(
                x.shape != y.shape for x, y in zip(_leaves(got),
                                                   _leaves(full))))
        # a run sharded on (2, 2) dies at step 3; it resumes on (4,)
        run = fault.ResumableRun(str(d / "run"), checkpoint_every=2)
        injector = fault.FailureInjector(fail_at_steps=(3,))
        step_fn, batches_fn, state = make_lm_run(CFG, device="cpu", **RUN)
        try:
            run.run(_sharded_step(step_fn, state, a, spec_a),
                    _shard(state, a, spec_a), batches_fn, RUN["steps"],
                    injector=injector, mesh=a, state_specs=spec_a)
            out["died"] = np.array(False)
        except fault.InjectedFailure:
            out["died"] = np.array(True)
        out["latest"] = np.array(run.latest())
        step_fn, batches_fn, state = make_lm_run(CFG, device="cpu", **RUN)
        resumed, done, _ = run.run(
            _sharded_step(step_fn, state, b, spec_b),
            _shard(state, b, spec_b), batches_fn, RUN["steps"],
            injector=injector, mesh=b, state_specs=spec_b)
        out["resumed_steps"] = np.array(done)
        step_fn, batches_fn, state = make_lm_run(CFG, device="cpu", **RUN)
        for i in range(RUN["steps"]):
            state, _ = step_fn(state, batches_fn(i))
        out["resume_equal"] = np.array(all(
            torch.equal(x, y) for x, y in zip(
                _leaves(resumed), _leaves(_shard(state, b, spec_b)))))
        # the reference's addressable shards, at this rank's coordinates
        tree = np.load(d / "tree.npz")
        for tag, (shape, axes) in MESHES.items():
            mesh = a if tag == "2x2" else b
            col = 1 if tag == "2x2" else 2
            specs = {k: ShardSpec.of(*v[col]) for k, v in TREE.items()}
            example = {k: mesh_lib.local_slice(torch.from_numpy(tree[k]),
                                               mesh, specs[k]).zero_()
                       for k in TREE}
            got = ckpt.restore(d / "tree_ck", 7, example, mesh=mesh,
                               specs=specs)
            for k, v in got.items():
                out[f"{tag}_{k}_{_coords(mesh)}"] = v.numpy()
    finally:
        mesh_lib.shutdown()
    np.savez(d / f"rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("reshard")
    rng = np.random.default_rng(3)
    tree = {k: rng.normal(size=v[0]).astype(np.float32)
            for k, v in TREE.items()}
    np.savez(d / "tree.npz", **tree)
    ckpt.save(d / "tree_ck", 7, {k: torch.from_numpy(v)
                                 for k, v in tree.items()})
    specs = {tag: [shape, axes, {k: v[1 if tag == "2x2" else 2]
                                 for k, v in TREE.items()}]
             for tag, (shape, axes) in MESHES.items()}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REF, str(d / "tree.npz"), str(d / "ref.npz"),
         json.dumps(specs), str(d / "ref_ck")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
        t_end = time.monotonic() + 240
        while not ctx.join(timeout=1):
            if time.monotonic() > t_end:
                pytest.fail("ranks still running after 240 s")
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
        for p in ctx.processes if ctx is not None else ():
            if p.is_alive():
                p.kill()
    assert ref.returncode == 0, err[-3000:]
    return types.SimpleNamespace(
        ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)],
        ref=dict(np.load(d / "ref.npz")), dir=d, tree=tree)


@pytest.mark.parametrize("tag", ["b", "c"])
def test_restore_on_another_mesh_shape(runs, tag):
    """Saved on (2, 2); restored on (4,) ("b") and on (2, 2) with the axes
    swapped ("c"): every rank's slices bit for bit."""
    for out in runs.ranks:
        assert bool(out[f"{tag}_equal"]) and bool(out[f"{tag}_sliced"])


def test_restore_in_one_process_and_file_layout(runs):
    """The mesh-saved checkpoint restores in one process bit for bit, and
    its arrays are those of a one-process save of the same state."""
    full = _full_state()
    example = ckpt._unflatten(full, iter(
        [torch.zeros_like(x) for x in _leaves(full)]))
    got = ckpt.restore(runs.dir / "ck", 5, example)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(got),
                                                  _leaves(full)))
    ckpt.save(runs.dir / "single", 5, full)
    with np.load(runs.dir / "ck" / "step_00000005" / "shard_0.npz") as a, \
            np.load(runs.dir / "single" / "step_00000005" /
                    "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert (runs.dir / "ck" / "step_00000005" / "meta.json").read_text() == \
        (runs.dir / "single" / "step_00000005" / "meta.json").read_text()


def test_resumed_run_on_another_mesh_equals_uninterrupted(runs):
    for out in runs.ranks:
        assert bool(out["died"]) and int(out["latest"]) == 1
        assert int(out["resumed_steps"]) == RUN["steps"] - 2
        assert bool(out["resume_equal"])


@pytest.mark.parametrize("tag", list(MESHES))
def test_slices_equal_reference_addressable_shards(runs, tag):
    n = 0
    for out in runs.ranks:
        for key, got in out.items():
            if key.startswith(f"{tag}_"):
                np.testing.assert_array_equal(got, runs.ref[key], key)
                n += 1
    assert n == WORLD * len(TREE)


def test_restore_refuses_missing_specs_and_wrong_shapes(tmp_path):
    state = {"w": torch.zeros(4, 4)}
    ckpt.save(tmp_path, 1, state)
    with pytest.raises(ValueError, match="another state"):
        ckpt.restore(tmp_path, 1, {"w": torch.zeros(2, 4)})
