"""The port's GPipe pipeline against the JAX package's, on the CPU.

Both snippets of the reference's ``tests/test_pipeline.py``: a 4-layer
tanh stack in 3 microbatches through ``pipeline_apply`` over "pod" (2
stages), and the transformer's ``pipeline_loss_fn`` on mesh (2, 2, 2)
("pod", "data", "model").  The reference runs once, in a subprocess with 8
virtual CPU devices and Auto mesh axes (jax 0.9's ``jax.make_mesh``
defaults to Explicit axes, which its ``shard_map`` specs refuse; that is
why the reference's own transformer case is red), and writes its values,
gradients and parameters to an ``.npz``.  The port's ranks are eight
``gloo`` processes, spawned once for the module (one intra-op thread
each, collectives timing out after 60 s); the transformer's weights come
from the reference through `convert.transformer_params`.  This module
imports no JAX.

Tolerances are the reference test's own: values within rtol 1e-5 / atol
1e-6, gradients within rtol 1e-4 / atol 1e-5, here for every leaf of the
gradient tree, against the reference's pipeline and its one-process
``loss_fn``.
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

from repro_torch import convert
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tf
from repro_torch.models.pipeline import pipeline_apply

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
L, D, N_MICRO, MB, S = 4, 16, 3, 2, 8
CFG = tf.TransformerConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab=512, d_head=16,
                           dtype="float32", remat=False, kv_chunk=32,
                           batch_axes=("data",))

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.models import transformer as tf
from repro.models.pipeline import pipeline_apply

def auto_mesh(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))

out = {}
mesh = auto_mesh((2,), ("pod",))
L, D, n_micro, mb, S = 4, 16, 3, 2, 8
rng = np.random.default_rng(0)
Ws = jnp.asarray(rng.normal(size=(L, D, D)).astype(np.float32) / np.sqrt(D))
x = jnp.asarray(rng.normal(size=(n_micro, mb, S, D)).astype(np.float32))
def stage_fn(w_local, h):
    for i in range(w_local.shape[0]):
        h = jnp.tanh(h @ w_local[i])
    return h
def pipe(Ws, x):
    return pipeline_apply(Ws, x, stage_fn, mesh=mesh, axis="pod",
                          inner_specs=P(None, None, None, None))
with mesh:
    out["apply_y"] = np.asarray(jax.jit(pipe)(Ws, x))
    out["apply_g"] = np.asarray(jax.jit(jax.grad(
        lambda w, x: jnp.sum(pipe(w, x) ** 2)))(Ws, x))
out["apply_w"], out["apply_x"] = np.asarray(Ws), np.asarray(x)

mesh = auto_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = tf.TransformerConfig(name="t", n_layers=4, d_model=64, n_heads=4,
                           n_kv_heads=2, d_ff=128, vocab=512, d_head=16,
                           dtype="float32", remat=False, kv_chunk=32,
                           batch_axes=("data",))
params = tf.init_params(jax.random.PRNGKey(0), cfg)
tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab)
pipe_loss = lambda p: tf.pipeline_loss_fn(p, cfg, tokens, tokens, mesh=mesh,
                                          n_micro=4)
with mesh:
    lp, gp = jax.jit(jax.value_and_grad(pipe_loss))(params)
    ls, gs = jax.jit(jax.value_and_grad(
        lambda p: tf.loss_fn(p, cfg, tokens, tokens)))(params)
out["tf_tokens"] = np.asarray(tokens)
out["tf_loss_pipe"], out["tf_loss_seq"] = np.asarray(lp), np.asarray(ls)
for tag, tree in (("p", params), ("gp", gp), ("gs", gs)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(k.key for k in path)
        out[f"{tag}:{name}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""


def _tree(ref: dict, tag: str) -> dict:
    """The nested dict of the reference's flattened ``tag:`` leaves."""
    out = {}
    for key, leaf in ref.items():
        if not key.startswith(tag + ":"):
            continue
        node = out
        *path, last = key[len(tag) + 1:].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    t_end = time.monotonic() + 240
    while not (d / "ref.npz").exists():          # the reference's output
        if time.monotonic() > t_end:
            raise TimeoutError("the reference wrote nothing")
        time.sleep(0.2)
    ref = dict(np.load(d / "ref.npz"))
    out = {}
    mesh_lib.init_ranks("gloo", store_path=d / "store", rank=rank,
                        world_size=WORLD, timeout_s=60)
    try:
        # the tanh stack: stage s holds layers 2s, 2s+1; "rest" replicates
        mesh = mesh_lib.make_mesh((2, 4), ("pod", "rest"), device="cpu",
                                  backend="gloo")
        stage = mesh_lib.axes_position(mesh, ("pod",))
        w = torch.from_numpy(ref["apply_w"][2 * stage:2 * stage + 2].copy())
        w.requires_grad_(True)

        def stage_fn(h):
            for i in range(w.shape[0]):
                h = torch.tanh(h @ w[i])
            return h

        y = pipeline_apply(stage_fn, torch.from_numpy(ref["apply_x"]),
                           mesh=mesh, axis="pod")
        (y ** 2).sum().backward()
        out["apply_y"] = y.detach().numpy()
        out["apply_g"] = w.grad.numpy()
        out["apply_stage"] = np.array(stage)
        # the transformer on (pod, data, model)
        mesh = mesh_lib.make_mesh((2, 2, 2), ("pod", "data", "model"),
                                  device="cpu", backend="gloo")
        model = convert.transformer_params(_tree(ref, "p"), CFG, device="cpu")
        model.requires_grad_(True)
        tf.pipeline_stage(model, mesh, "pod")
        tokens = torch.from_numpy(ref["tf_tokens"]).long()
        loss = tf.pipeline_loss(model, tokens, tokens, mesh=mesh, n_micro=4)
        loss.backward()
        out["tf_loss"] = loss.detach().numpy()
        own = tf._stage_range(CFG, mesh, "pod")
        for name, p in model.named_parameters():
            if name.startswith("layers."):
                i, rest = name[len("layers."):].split(".", 1)
                name = f"layers.{own[int(i)]}.{rest}"
            out[f"grad:{name}"] = p.grad.numpy()
        out["tf_copies"] = np.array(mesh.repro_comms.host_copies)
    finally:
        mesh_lib.shutdown()
    np.savez(d / f"rank{rank}.npz", **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d / "ref.tmp.npz")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
        os.replace(d / "ref.tmp.npz", d / "ref.npz")
        t_end = time.monotonic() + 240
        while not ctx.join(timeout=1):
            if time.monotonic() > t_end:
                pytest.fail("ranks still running after 240 s")
    finally:
        if ref.poll() is None:
            ref.kill()
        for p in ctx.processes if ctx is not None else ():
            if p.is_alive():
                p.kill()
    return types.SimpleNamespace(
        ranks=[dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)],
        ref=dict(np.load(d / "ref.npz")))


def test_pipeline_apply_matches_reference(runs):
    """Values within rtol 1e-5 / atol 1e-6 of the reference's pipeline,
    and each stage's weight gradients within rtol 1e-4 / atol 1e-5."""
    for out in runs.ranks:
        np.testing.assert_allclose(out["apply_y"], runs.ref["apply_y"],
                                   rtol=1e-5, atol=1e-6)
        s = int(out["apply_stage"])
        np.testing.assert_allclose(out["apply_g"],
                                   runs.ref["apply_g"][2 * s:2 * s + 2],
                                   rtol=1e-4, atol=1e-5)


def test_pipeline_loss_matches_reference(runs):
    """pipeline_loss on (2, 2, 2) equals the reference's pipeline_loss_fn
    and its one-process loss_fn within rtol 1e-5 / atol 1e-6, on every
    rank."""
    for out in runs.ranks:
        for want in (runs.ref["tf_loss_pipe"], runs.ref["tf_loss_seq"]):
            np.testing.assert_allclose(out["tf_loss"], want, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("against", ["gp", "gs"])
def test_pipeline_gradients_match_reference(runs, against):
    """Every rank holds the one-process gradient of every parameter it
    holds (its stage's layers, embed, final norm, unembed), leaf for leaf
    within rtol 1e-4 / atol 1e-5 of the reference's pipeline gradients
    ("gp") and of its one-process ``loss_fn`` gradients ("gs")."""
    want = convert._state_dict(_tree(runs.ref, against), CFG)
    seen = set()
    for out in runs.ranks:
        names = [k[len("grad:"):] for k in out if k.startswith("grad:")]
        assert len(names) == 3 + CFG.n_layers // 2 * 9
        for name in names:
            np.testing.assert_allclose(out[f"grad:{name}"],
                                       want[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
            seen.add(name)
    assert seen == set(want)


def test_pipeline_needs_whole_stages():
    with pytest.raises(ValueError, match="stages"):
        tf._stage_range(tf.TransformerConfig(
            name="t", n_layers=3, d_model=8, n_heads=1, n_kv_heads=1,
            d_ff=8, vocab=8), types.SimpleNamespace(
                mesh_dim_names=("pod",), size=lambda d: 2,
                get_local_rank=lambda d: 0), "pod")
