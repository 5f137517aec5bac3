"""The port's GNN (``repro_torch.models.gnn``) against the JAX package's.

Reduced graphcast (3 layers, d_hidden 32, float32) with the ``sum`` and
``mean`` aggregators: the forward, the loss and every gradient against
``jax.value_and_grad(loss_fn)`` (jitted), from the reference's parameters
carried across by `convert.gnn_params`; remat on equals remat off bit for
bit; one AdamW step from a state carried by `convert.opt_state` against
the reference's ``make_train_step``; the host-side sampler bit for bit.

Tolerances (float32 on the CPU): the predictions within 1e-5 of the
largest |prediction|; the loss within 1e-5 relative; each gradient and,
after the step, each parameter within 1e-4 of the reference's normwise.
The scatter-sums (``index_add`` against ``segment_sum``) add in orders of
their own, so nothing here is bit for bit across the packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import gnn
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer

V, E = 60, 240

_value_and_grad = jax.jit(jax.value_and_grad(jgnn.loss_fn), static_argnums=1)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    den = float(torch.linalg.vector_norm(want.double()))
    num = float(torch.linalg.vector_norm(got.double() - want.double()))
    return num / den if den else num


def _graph(cfg, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(V, cfg.d_feat)).astype(np.float32),
            rng.integers(0, V, E).astype(np.int32),
            rng.integers(0, V, E).astype(np.int32),
            rng.normal(size=(V, cfg.n_vars)).astype(np.float32))


def _configs(aggregator: str):
    jcfg = dataclasses.replace(jreg.get("graphcast").reduced,
                               aggregator=aggregator)
    cfg = dataclasses.replace(treg.get("graphcast").reduced,
                              aggregator=aggregator)
    return jcfg, cfg


def _world(aggregator: str, seed: int = 3):
    jcfg, cfg = _configs(aggregator)
    params = jgnn.init_params(jax.random.PRNGKey(seed), jcfg)
    model = convert.gnn_params(jax.tree.map(np.asarray, params), cfg,
                               device="cpu")
    return jcfg, cfg, params, model, _graph(cfg, seed + 1)


def test_reduced_config_equals_reference():
    for arch in ("graphcast",):
        j, t = jreg.get(arch), treg.get(arch)
        assert dataclasses.asdict(j.config) == dataclasses.asdict(t.config)
        assert dataclasses.asdict(j.reduced) == dataclasses.asdict(t.reduced)
        assert j.scan_trip_count() == t.scan_trip_count() == 16


@pytest.mark.parametrize("aggregator", ["sum", "mean"])
def test_forward_loss_and_grads_match_reference(aggregator):
    jcfg, cfg, params, model, graph = _world(aggregator)
    jbatch = jgnn.GraphBatch(*map(jnp.asarray, graph))
    tbatch = gnn.GraphBatch(*map(torch.from_numpy, graph))
    want = np.asarray(jgnn.forward(params, jcfg, jbatch))
    with torch.no_grad():
        got = model(tbatch).numpy()
    assert got.shape == want.shape == (V, cfg.n_vars)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    want_loss, want_grads = _value_and_grad(params, jcfg, jbatch)
    model.requires_grad_(True)
    loss, grads = trainer.value_and_grad(
        lambda p, *b: model.loss(gnn.GraphBatch(*b)),
        dict(model.named_parameters()), tuple(tbatch))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_g = convert._state_dict(jax.tree.map(np.asarray, want_grads), cfg)
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        assert grads[k].shape == w.shape, k
        assert _rel(grads[k], w) <= 1e-4, (k, _rel(grads[k], w))


def test_remat_equals_no_remat_bit_for_bit():
    _, cfg, _, _, graph = _world("sum")
    out = {}
    for remat in (False, True):
        model = gnn.Gnn(dataclasses.replace(cfg, remat=remat),
                        generator=torch.Generator().manual_seed(5),
                        device="cpu").requires_grad_(True)
        out[remat] = trainer.value_and_grad(
            lambda p, *b: model.loss(gnn.GraphBatch(*b)),
            dict(model.named_parameters()),
            tuple(map(torch.from_numpy, graph)))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_adamw_step_matches_reference():
    """One step of the reference's ``make_train_step`` (as
    tests/test_arch_smoke.py runs it) against the port's, from the same
    parameters and optimizer state."""
    jcfg, cfg, params, model, graph = _world("sum", seed=7)
    ocfg = dict(warmup_steps=1, total_steps=10)
    jstate = jopt.init(params, jopt.AdamWConfig(**ocfg))
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, nf, es, ed, t: jgnn.loss_fn(
            p, jcfg, jgnn.GraphBatch(nf, es, ed, t)),
        jopt.AdamWConfig(**ocfg), param_dtype=jcfg.jdtype))
    jp, _, jm = jstep(params, jstate, tuple(map(jnp.asarray, graph)))

    model.requires_grad_(True)
    tparams = dict(model.named_parameters())
    tstate = convert.opt_state(jax.tree.map(np.asarray, jstate), cfg,
                               device="cpu")
    tstep = trainer.make_train_step(
        lambda p, *b: model.loss(gnn.GraphBatch(*b)),
        opt_lib.AdamWConfig(**ocfg), param_dtype=cfg.torch_dtype)
    tp, tstate, tm = tstep(tparams, tstate,
                           tuple(map(torch.from_numpy, graph)))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    want = convert._state_dict(jax.tree.map(np.asarray, jp), cfg)
    for k, w in want.items():
        assert _rel(tp[k].detach(), w) <= 1e-4, k
    assert int(tstate.step) == 1


def test_sampler_equals_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    n, e = 300, 2000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    joff, jnbr = jgnn.build_csr(src, dst, n)
    toff, tnbr = gnn.build_csr(src, dst, n)
    np.testing.assert_array_equal(joff, toff)
    np.testing.assert_array_equal(jnbr, tnbr)
    want = jgnn.sample_fanout(np.random.default_rng(9), joff, jnbr,
                              np.arange(0, 40, 3), fanouts=(5, 3))
    got = gnn.sample_fanout(np.random.default_rng(9), toff, tnbr,
                            np.arange(0, 40, 3), fanouts=(5, 3))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_abstract_params_are_meta_at_full_width():
    cfg = treg.get("graphcast").config
    got = gnn.abstract_params(cfg)
    want = convert._state_dict(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        jgnn.abstract_params(dataclasses.replace(
            jreg.get("graphcast").config, n_layers=2))),
        dataclasses.replace(cfg, n_layers=2))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in got.values())
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
    assert len(got) == len(want) + 14 * 8       # 8 tensors a layer
