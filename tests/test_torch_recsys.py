"""The port's recsys models (``repro_torch.models.recsys``) against the JAX
package's, and the registry's assigned archs.

For FM, two-tower, DIEN and DCN-v2 at their reduced configs: the forward,
the loss and every gradient against ``jax.value_and_grad`` of the
reference's loss (jitted), from the reference's parameters carried across
by `convert.recsys_params`; one AdamW step from a state carried by
`convert.opt_state` against the reference's ``make_train_step`` (as
tests/test_arch_smoke.py runs it); `embedding_bag` in both modes and the
reference's brute-force FM check (tests/test_models.py).

Tolerances (float32 on the CPU): outputs within 1e-5 of the largest
|output|, the loss within 1e-5 relative, each gradient and each
parameter after the step within 1e-4 normwise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import families as jfam
from repro.configs import registry as jreg
from repro.models import recsys as jrec
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import recsys
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer

ARCHS = ["fm", "two-tower-retrieval", "dien", "dcn-v2"]
B = 16


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want)).double()
    den = float(torch.linalg.vector_norm(want))
    num = float(torch.linalg.vector_norm(got.detach().double() - want))
    return num / den if den else num


def _batch(arch: str, cfg, seed: int) -> tuple:
    """A training batch of the reduced config (tests/test_arch_smoke.py's
    ranges), numpy."""
    rng = np.random.default_rng(seed)
    lbl = lambda: rng.integers(0, 2, B).astype(np.float32)
    if arch == "fm":
        return (rng.integers(0, cfg.n_sparse * cfg.vocab_per_field,
                             (B, cfg.n_sparse)).astype(np.int32), lbl())
    if arch == "dcn-v2":
        return (rng.normal(size=(B, cfg.n_dense)).astype(np.float32),
                rng.integers(0, cfg.n_sparse * cfg.vocab_per_field,
                             (B, cfg.n_sparse)).astype(np.int32), lbl())
    if arch == "dien":
        return (rng.integers(0, cfg.item_vocab,
                             (B, cfg.seq_len)).astype(np.int32),
                rng.integers(0, cfg.item_vocab, B).astype(np.int32), lbl())
    return (rng.integers(0, cfg.user_vocab,
                         (B, cfg.n_user_feats)).astype(np.int32),
            rng.integers(0, cfg.item_vocab,
                         (B, cfg.n_item_feats)).astype(np.int32))


def _world(arch: str, seed: int):
    jcfg, cfg = jreg.get(arch).reduced, treg.get(arch).reduced
    params = jfam._recsys_init(arch, jcfg, abstract=False,
                               key=jax.random.PRNGKey(seed))
    model = convert.recsys_params(arch, jax.tree.map(np.asarray, params),
                                  cfg, device="cpu")
    return jcfg, cfg, params, model, _batch(arch, cfg, seed + 1)


def _jforward(arch, params, cfg, batch):
    if arch == "two-tower-retrieval":
        return jfam._recsys_forward(arch, cfg)(params, *batch)
    return jfam._recsys_forward(arch, cfg)(params, *batch[:-1])


def _tloss(model):
    return lambda p, *b: model.loss(*map(torch.from_numpy, b))


def test_configs_equal_reference():
    for arch in ARCHS:
        j, t = jreg.get(arch), treg.get(arch)
        assert dataclasses.asdict(j.config) == dataclasses.asdict(t.config)
        assert dataclasses.asdict(j.reduced) == dataclasses.asdict(t.reduced)
        assert j.scan_trip_count() == t.scan_trip_count()
        assert j.family == t.family == "recsys"
        assert list(j.shapes) == list(t.shapes)


def test_registry_covers_assignment():
    assert set(treg.ASSIGNED) == set(jreg.ASSIGNED)
    assert len(treg.ASSIGNED) == 10
    total = sum(len(treg.get(a).shapes) for a in treg.ASSIGNED)
    assert total == 40
    assert treg.get("dien").scan_trip_count() == 100


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    jcfg, cfg, params, model, batch = _world(arch, 11)
    want = np.asarray(_jforward(arch, params, jcfg,
                                tuple(map(jnp.asarray, batch))))
    with torch.no_grad():
        inputs = batch if arch == "two-tower-retrieval" else batch[:-1]
        got = model(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape == (B,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    _, _, jloss = jfam._recsys_batch(arch, jcfg, B)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
        params, *map(jnp.asarray, batch))
    model.requires_grad_(True)
    loss, grads = trainer.value_and_grad(
        _tloss(model), dict(model.named_parameters()), batch)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_g = convert._state_dict(jax.tree.map(np.asarray, want_grads), cfg)
    assert set(grads) == set(want_g)
    for k, w in want_g.items():
        assert tuple(grads[k].shape) == tuple(w.shape), k
        assert _rel(grads[k], w) <= 1e-4, (k, _rel(grads[k], w))


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    jcfg, cfg, params, model, batch = _world(arch, 21)
    ocfg = dict(warmup_steps=1, total_steps=10)
    _, _, jloss = jfam._recsys_batch(arch, jcfg, B)
    jstate = jopt.init(params, jopt.AdamWConfig(**ocfg))
    jstep = jax.jit(jtrainer.make_train_step(
        jloss, jopt.AdamWConfig(**ocfg), param_dtype=jcfg.jdtype))
    jp, _, jm = jstep(params, jstate, tuple(map(jnp.asarray, batch)))

    model.requires_grad_(True)
    tstate = convert.opt_state(jax.tree.map(np.asarray, jstate), cfg,
                               device="cpu")
    tstep = trainer.make_train_step(_tloss(model),
                                    opt_lib.AdamWConfig(**ocfg),
                                    param_dtype=cfg.torch_dtype)
    tp, tstate, tm = tstep(dict(model.named_parameters()), tstate, batch)
    assert np.isfinite(float(tm["loss"])) and float(tm["grad_norm"]) > 0
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    for k, w in convert._state_dict(jax.tree.map(np.asarray, jp),
                                    cfg).items():
        assert _rel(tp[k], w) <= 1e-4, k
    assert int(tstate.step) == 1


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    segs = np.sort(rng.integers(0, 9, 40)).astype(np.int32)  # bag 9 empty
    want = np.asarray(jrec.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                         jnp.asarray(segs), 10, mode=mode))
    got = recsys.embedding_bag(torch.from_numpy(table), ids, segs, 10,
                               mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the reference's literal cases (tests/test_models.py)
    t = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    s = recsys.embedding_bag(t, [0, 1, 2, 5], [0, 0, 1, 1], 2, mode=mode)
    assert s.tolist() == ([[2.0, 4.0], [14.0, 16.0]] if mode == "sum"
                          else [[1.0, 2.0], [7.0, 8.0]])


def test_fm_sum_square_trick_brute_force():
    """The reference's brute-force pairwise check, on the port's FM."""
    cfg = recsys.FmConfig(n_sparse=5, embed_dim=4, vocab_per_field=100)
    model = recsys.Fm(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    with torch.no_grad():
        model.bias.fill_(0.25)
    ids = np.random.default_rng(0).integers(0, 500, (3, 5)).astype(np.int32)
    with torch.no_grad():
        logits = model(ids).numpy()
        emb = recsys.embedding_lookup(model.table, ids).numpy()
        lin = recsys.embedding_lookup(model.linear, ids).numpy()[..., 0]
    want = []
    for b in range(3):
        tot = float(model.bias) + lin[b].sum()
        for i in range(5):
            for j in range(i + 1, 5):
                tot += float(emb[b, i] @ emb[b, j])
        want.append(tot)
    np.testing.assert_allclose(logits, want, rtol=1e-4)


def test_twotower_scoring_and_unit_norm():
    jcfg, cfg, params, model, _ = _world("two-tower-retrieval", 31)
    rng = np.random.default_rng(2)
    uf = rng.integers(0, cfg.user_vocab, (4, cfg.n_user_feats)).astype(
        np.int32)
    cands = rng.normal(size=(50, cfg.tower_mlp[-1])).astype(np.float32)
    want = np.asarray(jrec.twotower_score_candidates(
        params, jcfg, jnp.asarray(uf), jnp.asarray(cands)))
    with torch.no_grad():
        got = model.score_candidates(uf, torch.from_numpy(cands)).numpy()
        u = model.user_embedding(uf)
    assert got.shape == (4, 50)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.allclose(torch.linalg.vector_norm(u, dim=-1),
                          torch.ones(4), atol=1e-5)


def test_table_spec_is_row_sharded():
    assert recsys.table_spec() == recsys.table_spec("model")
    assert recsys.table_spec().dims == (("model",), ())
