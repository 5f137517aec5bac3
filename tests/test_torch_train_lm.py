"""The port's LM training path against the JAX package's: the loss and
every gradient of the reduced LM configs (the reference's
``jax.value_and_grad(loss_fn)``, jitted), remat, three steps of
``make_lm_run``, the ``launch.train`` CLI and the ``train_lm`` example.
Parameters and optimizer state are carried across by `repro_torch.convert`.

Tolerances (float32 on the CPU): the loss within 1e-5, each gradient
within 1e-4 of the reference's normwise; after three AdamW steps the
losses within 1e-5 and each parameter within 1e-4 normwise.  On the MoE
configs an input is used only where every token's k-th and (k+1)-th
router logits lie more than 1e-4 apart (below that the two sides may
route a token to different experts)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.launch import train as jtrain
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.examples import train_lm
from repro_torch.launch import train as ttrain
from repro_torch.models import moe as moe_lib
from repro_torch.train import trainer

ARCHS = ["llama3-8b", "qwen3-8b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m"]
GAP = 1e-4

_init = jax.jit(jt.init_params, static_argnums=1)
_value_and_grad = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnums=1)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    den = float(torch.linalg.vector_norm(want.double()))
    num = float(torch.linalg.vector_norm(got.double() - want.double()))
    return num / den if den else num


def _min_router_gap(model, tokens) -> float:
    """Smallest k-th/(k+1)-th router-logit gap over every token and MoE
    layer of a forward on ``tokens`` (inf on a dense model)."""
    gaps = []

    def hook(mod, inputs, _out):
        _, values, _ = moe_lib.route(mod, inputs[0], mod.spec)
        k = mod.spec.top_k
        gaps.append(float((values[..., k - 1] - values[..., k]).min()))

    hooks = [blk.moe.register_forward_hook(hook) for blk in model.layers
             if hasattr(blk, "moe")]
    try:
        with torch.no_grad():
            model.forward(tokens)
    finally:
        for h in hooks:
            h.remove()
    return min(gaps, default=float("inf"))


def _clear_batch(model, vocab: int, shape, seed: int):
    """The first seeded (tokens, targets) from ``seed`` on whose tokens no
    router gap is at or below GAP."""
    for s in range(seed, seed + 20):
        tokens = np.random.default_rng(s).integers(
            0, vocab, size=shape).astype(np.int32)
        if _min_router_gap(model, tokens) > GAP:
            return tokens, np.roll(tokens, -1, axis=1)
    raise AssertionError("no input clear of router near-ties in 20 draws")


def _port_grads(model, tokens, targets) -> tuple:
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return trainer.value_and_grad(
        lambda p, t, y: model.loss(t, y), params, (tokens, targets))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg = jreg.get(arch).reduced
    cfg = treg.get(arch).reduced
    params = _init(jax.random.PRNGKey(11), jcfg)
    model = convert.transformer_params(jax.tree.map(np.asarray, params), cfg,
                                       device="cpu")
    tokens, targets = _clear_batch(model, cfg.vocab, (2, 24), seed=12)
    want_loss, want_grads = _value_and_grad(params, jcfg,
                                            jnp.asarray(tokens),
                                            jnp.asarray(targets))
    loss, grads = _port_grads(model, tokens, targets)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = convert._state_dict(jax.tree.map(np.asarray, want_grads), cfg)
    assert set(grads) == set(want)
    for k, w in want.items():
        assert grads[k].shape == w.shape
        assert bool(torch.isfinite(grads[k]).all()), k
        assert _rel(grads[k], w) <= 1e-4, (k, _rel(grads[k], w))


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_remat_grads_equal_no_remat_bit_for_bit(arch):
    """``cfg.remat`` checkpoints each block (the MoE's scatters into fresh
    buffers recomputed): the same loss and gradients, bit for bit."""
    cfg = treg.get(arch).reduced
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = ttrain.Transformer(c, generator=torch.Generator().manual_seed(
            5), device="cpu")
        tokens = np.random.default_rng(6).integers(
            0, c.vocab, size=(2, 20)).astype(np.int32)
        out[remat] = _port_grads(model, tokens, np.roll(tokens, -1, axis=1))
    (l0, g0), (l1, g1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_remat_saves_only_block_inputs():
    """Under remat the forward keeps fewer activations for the backward."""
    cfg = dataclasses.replace(treg.get("llama3-8b").reduced, n_layers=3)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 64))
    saved = {}
    for remat in (False, True):
        model = ttrain.Transformer(dataclasses.replace(cfg, remat=remat),
                                   generator=torch.Generator().manual_seed(0),
                                   device="cpu").requires_grad_(True)
        nbytes = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: nbytes.append(t.numel() * t.element_size()) or t,
                lambda t: t):
            model.loss(tokens, np.roll(tokens, -1, axis=1))
        saved[remat] = sum(nbytes)
    assert saved[True] < saved[False] / 2


@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_lm_run_three_steps_match_reference(microbatches):
    jcfg = jreg.get("llama3-8b").reduced
    cfg = treg.get("llama3-8b").reduced
    jstep, jbatches, jstate = jtrain.make_lm_run(
        jcfg, batch=4, seq=32, lr=3e-3, steps=3, microbatches=microbatches)
    model = convert.transformer_params(jax.tree.map(np.asarray, jstate[0]),
                                       cfg, device="cpu")
    step, batches, state = ttrain.make_lm_run(
        cfg, batch=4, seq=32, lr=3e-3, steps=3, microbatches=microbatches,
        model=model)
    assert state[0]["embed"] is model.embed
    for i in range(3):
        batch = jbatches(i)
        for a, b in zip(batches(i), batch):
            np.testing.assert_array_equal(a, b)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        assert m["loss"] == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state[1].step) == 3
    want = convert._state_dict(jax.tree.map(np.asarray, jstate[0]), cfg)
    for k, w in want.items():
        assert _rel(state[0][k].detach(), w) <= 1e-4, k


def test_make_lm_run_rejects_a_foreign_state():
    cfg = treg.get("llama3-8b").reduced
    step, batches, _ = ttrain.make_lm_run(cfg, batch=2, seq=16, lr=1e-3,
                                          steps=2, device="cpu")
    _, _, other = ttrain.make_lm_run(cfg, batch=2, seq=16, lr=1e-3, steps=2,
                                     device="cpu")
    with pytest.raises(ValueError, match="model's parameters"):
        step(other, batches(0))


def test_make_lm_run_draws_seeded_weights():
    cfg = treg.get("qwen3-8b").reduced
    a = ttrain.make_lm_run(cfg, batch=2, seq=16, lr=1e-3, steps=2,
                           device="cpu", seed=3)[2][0]
    b = ttrain.make_lm_run(cfg, batch=2, seq=16, lr=1e-3, steps=2,
                           device="cpu", seed=3)[2][0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(p.requires_grad for p in a.values())


def test_train_cli_drill_and_resume(tmp_path, capsys, monkeypatch):
    """The port's CLI on the CPU: a drill that dies at step 2 after a
    checkpoint at step 1, then a restart that resumes from it and prints
    the reference CLI's keys (the reference's own run, in process)."""
    ck = str(tmp_path / "port")
    args = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ck, "--ckpt-every", "2"]
    with pytest.raises(ttrain.fault.InjectedFailure, match="step 2"):
        ttrain.main(args + ["--fail-at", "2"])
    assert ttrain.fault.ResumableRun(ck).latest() == 1
    out = ttrain.main(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert out["arch"] == "llama3-8b-smoke" and out["steps_run"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])

    monkeypatch.setattr("sys.argv", [
        "train", "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
        str(tmp_path / "ref"), "--ckpt-every", "2"])
    jtrain.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == set(want) and want["arch"] == out["arch"]


def test_train_cli_rejects_a_non_lm_arch(tmp_path):
    with pytest.raises(SystemExit, match="LM archs"):
        ttrain.main(["--device", "cpu", "--arch", "remoterag",
                     "--ckpt-dir", str(tmp_path)])


def test_train_lm_example_drill(tmp_path, capsys):
    """The example's ~100M model, a few steps on the CPU: the drill dies a
    third of the way in, restarts (no checkpoint yet: from scratch), and
    the loss decreases."""
    cfg = train_lm.config_100m()
    assert 80e6 < cfg.param_count() < 120e6
    history = train_lm.main(["--device", "cpu", "--steps", "6", "--batch",
                             "2", "--seq", "32", "--ckpt-dir",
                             str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "[drill] injected failure at step 2" in out
    assert "resumed and ran 6 steps" in out
    assert len(history) == 6 and history[-1]["loss"] < history[0]["loss"]
    assert (tmp_path / "ck" / "step_00000005" / "COMMIT").exists()
