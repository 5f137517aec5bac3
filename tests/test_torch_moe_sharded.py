"""The port's expert-parallel MoE (``moe_fwd_sharded``) against the JAX
package's, on the CPU, with gradients; then the transformer's MoE path
over a mesh against the single-process port.

The port's ranks are four ``gloo`` processes on a (2, 2) ``("data",
"model")`` mesh, spawned once for the module (a ``FileStore`` rendezvous
under a temporary directory, one intra-op thread each): tokens split over
"data", experts over "model".  The reference runs once, in a subprocess
with 8 virtual CPU devices and Auto mesh axes (jax 0.9's ``jax.make_mesh``
defaults to Explicit axes, which its ``shard_map`` specs refuse): its
``tests/test_moe_sharded.py`` case (d 32, d_ff 16, 8 experts, top-2,
``ep_pad_to`` 4, params from ``moe_params(PRNGKey(0))``, x from
``PRNGKey(1)``), einsum and sharded on its (2, 4) mesh.  This module
imports no JAX.

Tolerances (the reference's own for sharded vs einsum): outputs within
rtol 1e-4, atol 1e-5, aux within 1e-5, gradients of ``sum(o^2) + aux``
within rtol 1e-3, atol 1e-4; the transformer's logits within 1e-5 of the
single-process port, relative to their largest magnitude (the partial
outputs sum in another order than the single-process combine).
"""

import dataclasses
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

from repro_torch.configs import qwen3_moe_30b_a3b
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import ShardSpec
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
KW = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, ep_pad_to=4)
WEIGHTS = ("router", "w_gate", "w_up", "w_down")
LM_BATCH, LM_SEQ = 4, 16

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import moe

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
kw = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, ep_pad_to=4,
          batch_axes=("data",), ep_axis="model")
spec_e = moe.MoeSpec(**kw)
spec_s = moe.MoeSpec(**kw, impl="shard_a2a", mesh=mesh)
params = moe.moe_params(jax.random.PRNGKey(0), spec_e, jnp.float32, False)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32))

def loss_e(p, x):
    o, a = moe.moe_fwd_einsum(p, x, spec_e)
    return jnp.sum(o * o) + a

with mesh:
    oe, ae = jax.jit(lambda p, x: moe.moe_fwd_einsum(p, x, spec_e))(params, x)
    os_, as_ = jax.jit(lambda p, x: moe.moe_fwd_sharded(p, x, spec_s))(
        params, x)
    ge = jax.jit(jax.grad(loss_e))(params, x)
out = {f"p_{k}": np.asarray(v) for k, v in params.items()}
out.update({f"g_{k}": np.asarray(v) for k, v in ge.items()})
out.update(x=np.asarray(x), oe=np.asarray(oe), ae=np.asarray(ae),
           os=np.asarray(os_), as_=np.asarray(as_))
np.savez(sys.argv[1] + ".tmp.npz", **out)
os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])   # whole, or not there
"""


def _lm_cfg(mesh=None) -> tt.TransformerConfig:
    """The reduced Qwen3-MoE config (2 layers, 8 experts, top-2), tp = 2:
    over a mesh, tokens over "data" and experts over "model"."""
    cfg = dataclasses.replace(qwen3_moe_30b_a3b.REDUCED, tp=2)
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, batch_axes=("data",), moe_impl="shard_a2a",
                               mesh=mesh)


def _lm_model(cfg) -> tt.Transformer:
    return tt.Transformer(cfg, generator=torch.Generator().manual_seed(5),
                          device="cpu")


def _lm_tokens() -> np.ndarray:
    return np.random.default_rng(9).integers(0, 1024, size=(LM_BATCH, LM_SEQ))


def _rank_main(rank: int, workdir: str) -> None:
    torch.set_num_threads(1)
    d = Path(workdir)
    # the ranks start while the reference computes its parameters
    t_end = time.monotonic() + 240
    while not (d / "ref.npz").exists():
        if time.monotonic() > t_end:
            raise TimeoutError("no reference results")
        time.sleep(0.2)
    ref = np.load(d / "ref.npz")
    out = {}
    mesh_lib.init_ranks("gloo", store_path=d / "store", rank=rank,
                        world_size=WORLD, timeout_s=120)
    try:
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"), device="cpu",
                                  backend="gloo")
        spec = tm.MoeSpec(**KW, batch_axes=("data",), ep_axis="model",
                          impl="shard_a2a", mesh=mesh)
        layer = tm.Moe(spec, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
        layer.load_state_dict({k: torch.from_numpy(ref[f"p_{k}"])
                               for k in WEIGHTS}, strict=True)
        experts = {"router": ShardSpec.of(None, None),
                   **{k: ShardSpec.of("model") for k in WEIGHTS[1:]}}
        tt.shard_params(layer, mesh, experts)
        layer.requires_grad_(True)
        b_loc = ref["x"].shape[0] // 2
        pos = mesh_lib.axes_position(mesh, ("data",))
        x = torch.from_numpy(ref["x"][pos * b_loc:(pos + 1) * b_loc].copy())
        o, aux = tm.moe_fwd(layer, x, spec)
        (torch.sum(o * o) + aux).backward()
        out["o"] = mesh_lib.all_gather(o.detach(), mesh, ("data",)).reshape(
            ref["x"].shape).numpy()
        out["aux"] = aux.detach().numpy()
        for k in WEIGHTS:
            g = mesh_lib.all_reduce(getattr(layer, k).grad, mesh, ("data",))
            out[f"g_{k}"] = mesh_lib.gather_full(g, mesh,
                                                 experts[k]).numpy()
        out["e_loc"] = np.array(layer.w_gate.shape[0])

        cfg = _lm_cfg(mesh)
        model = tt.shard_params(_lm_model(cfg), mesh,
                                tt.expert_parallel_specs(cfg))
        b_loc = LM_BATCH // 2
        tokens = _lm_tokens()[pos * b_loc:(pos + 1) * b_loc]
        with torch.no_grad():
            logits, lm_aux = model(tokens)
        out["lm_logits"] = mesh_lib.all_gather(logits, mesh, ("data",)) \
            .reshape(LM_BATCH, LM_SEQ, -1).numpy()
        out["lm_aux"] = lm_aux.numpy()
        out["lm_e_loc"] = np.array(model.layers[0].moe.w_up.shape[0])
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
    """(rank results, reference results, single-process LM forward)."""
    d = tmp_path_factory.mktemp("moe")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d / "ref.npz")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ctx = None
    try:
        ctx = mp.spawn(_rank_main, args=(str(d),), nprocs=WORLD, join=False)
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
        with torch.no_grad():
            logits, aux = _lm_model(_lm_cfg())(_lm_tokens())
        _join(ctx)
    finally:
        _stop(ref, ctx)
    return types.SimpleNamespace(
        ranks=[dict(np.load(d / f"rank{k}.npz")) for k in range(WORLD)],
        ref=dict(np.load(d / "ref.npz")),
        lm=(logits.numpy(), aux.numpy()))


def test_sharded_moe_matches_reference_einsum_and_sharded(runs):
    ref = runs.ref
    for out in runs.ranks:
        assert int(out["e_loc"]) == 4
        np.testing.assert_allclose(out["o"], ref["oe"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out["o"], ref["os"], rtol=1e-4, atol=1e-5)
        assert abs(float(out["aux"]) - float(ref["ae"])) < 1e-5
        assert abs(float(out["aux"]) - float(ref["as_"])) < 1e-5


@pytest.mark.parametrize("name", WEIGHTS)
def test_sharded_moe_gradients_match_reference(runs, name):
    """Gradients of sum(o^2) + aux, summed over the batch axis: the
    combine's all-reduce has an identity backward, so the replicated
    cotangent is not counted once per EP rank."""
    for out in runs.ranks:
        np.testing.assert_allclose(out[f"g_{name}"], runs.ref[f"g_{name}"],
                                   rtol=1e-3, atol=1e-4)


def test_transformer_moe_path_over_mesh_equals_single_process(runs):
    want_logits, want_aux = runs.lm
    scale = np.abs(want_logits).max()
    for out in runs.ranks:
        assert int(out["lm_e_loc"]) == 4
        assert np.abs(out["lm_logits"] - want_logits).max() <= 1e-5 * scale
        assert abs(float(out["lm_aux"]) - float(want_aux)) <= \
            1e-5 * abs(float(want_aux))


def test_sharded_moe_refuses_unsharded_experts():
    mesh = types.SimpleNamespace(
        mesh_dim_names=("data", "model"), size=lambda d: 2,
        repro_comms=None)
    spec = tm.MoeSpec(**KW, batch_axes=("data",), ep_axis="model",
                      impl="shard_a2a", mesh=mesh)
    layer = tm.Moe(spec, torch.Generator().manual_seed(0),
                   torch.device("cpu"))
    with pytest.raises(ValueError, match="shard_params"):
        tm.moe_fwd(layer, torch.zeros(2, 4, 32), spec)
