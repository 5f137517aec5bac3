"""The port's training substrate against the JAX package's: the data
pipeline, the AdamW schedule and step, checkpoints, fault drills and int8
compression.  The reference's own ``tests/test_train.py`` cases run again
here on the port (same names, ``_port`` appended).

Tolerances: pipeline batches and int8 codes bit for bit; the schedule
within 1e-6 relative (float32 on both sides, ``cos`` and ``pow`` from two
libraries: an ulp or two); an AdamW step from the same state and grads
within 1e-6 relative on master, m and v, normwise per tensor."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import transformer as jt
from repro.train import compress as jcompress
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import ClickSyntheticTask, LmSyntheticTask
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compress, fault
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import trainer


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want))
    den = float(torch.linalg.vector_norm(want.double()))
    num = float(torch.linalg.vector_norm(got.detach().double() - want.double()))
    return num / den if den else num


# -- the pipeline: bit-identical batches ---------------------------------

@pytest.mark.parametrize("task", [
    dict(kind="lm", vocab=1000, seq_len=40, global_batch=4, seed=3),
    dict(kind="lm", vocab=128256, seq_len=64, global_batch=2, seed=0),
    dict(kind="click", n_sparse=10, vocab_per_field=100, global_batch=64),
    dict(kind="click", n_sparse=6, vocab_per_field=50, global_batch=32,
         n_dense=13, seed=5),
])
def test_pipeline_batches_bit_identical(task):
    kind = task.pop("kind")
    name = "LmSyntheticTask" if kind == "lm" else "ClickSyntheticTask"
    want_task = getattr(jpipe, name)(**task)
    got_task = getattr(tpipe, name)(**task)
    for step in (0, 1, 7, 123):
        want, got = want_task.batch(step), got_task.batch(step)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 4), (3, 4), (2, 3)])
def test_host_shard_matches_reference(shard, num_shards):
    x = np.arange(48).reshape(12, 4)
    np.testing.assert_array_equal(tpipe.host_shard(x, shard, num_shards),
                                  jpipe.host_shard(x, shard, num_shards))


# -- the schedule ----------------------------------------------------------

@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1),
    dict(lr=3e-3, warmup_steps=2, total_steps=50),
    dict(lr=3e-4, warmup_steps=0, total_steps=1),
])
def test_schedule_matches_reference(cfg):
    """Warm-up, cosine, the end and beyond it, int and tensor steps."""
    tcfg, jcfg = opt_lib.AdamWConfig(**cfg), jopt.AdamWConfig(**cfg)
    total = cfg["total_steps"]
    for step in sorted({0, 1, 2, 5, 9, 10, 11, total // 2, total - 1, total,
                        total + 1, 3 * total}):
        want = float(jopt.schedule(jcfg, jnp.int32(step)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = opt_lib.schedule(tcfg, s)
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12)


# -- one AdamW step from a carried state -----------------------------------

@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_apply_from_carried_state_matches_reference(clip_norm):
    """The reference's state after one step (reduced llama3-8b's params)
    carried across by `convert.opt_state`; the same grads through both
    ``apply``s."""
    jcfg = jreg.get("llama3-8b").reduced
    cfg = treg.get("llama3-8b").reduced
    params = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), jcfg)
    ocfg = dict(lr=1e-2, warmup_steps=3, total_steps=20, clip_norm=clip_norm)
    jo, to = jopt.AdamWConfig(**ocfg), opt_lib.AdamWConfig(**ocfg)
    rng = np.random.default_rng(4)
    draw = lambda: jax.tree.map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                              * 0.3), params)
    _, state, _ = jopt.apply(draw(), jopt.init(params, jo), jo)
    grads = draw()
    want_params, want, want_stats = jopt.apply(grads, state, jo)

    state_np = jax.tree.map(np.asarray, state)
    model = convert.transformer_params(state_np.master, cfg, device="cpu")
    tparams = dict(model.named_parameters())
    tstate = convert.opt_state(state_np, cfg, device="cpu")
    assert int(tstate.step) == 1
    tgrads = convert._state_dict(jax.tree.map(np.asarray, grads), cfg)
    got_params, got, stats = opt_lib.apply(tgrads, tstate, to,
                                           params=tparams)
    assert int(got.step) == 2
    assert float(stats["grad_norm"]) == pytest.approx(
        float(want_stats["grad_norm"]), rel=1e-6)
    assert float(stats["lr"]) == pytest.approx(float(want_stats["lr"]),
                                               rel=1e-6)
    for name, tree in (("master", want.master), ("m", want.m), ("v", want.v)):
        flat = convert._state_dict(jax.tree.map(np.asarray, tree), cfg)
        for k, w in flat.items():
            assert _rel(getattr(got, name)[k], w) <= 1e-6, (name, k)
    flat = convert._state_dict(jax.tree.map(np.asarray, want_params), cfg)
    for k, w in flat.items():
        assert _rel(got_params[k], w) <= 1e-6, k
        assert got_params[k] is tparams[k]        # updated in place


def test_apply_casts_into_bf16_params_and_keeps_fp32_master():
    p = {"w": torch.linspace(-1, 1, 7, dtype=torch.bfloat16)}
    cfg = opt_lib.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=10)
    state = opt_lib.init(p, cfg)
    assert state.master["w"].dtype == torch.float32
    assert state.master["w"].data_ptr() != p["w"].data_ptr()
    g = {"w": torch.ones(7, dtype=torch.bfloat16)}
    _, state, _ = opt_lib.apply(g, state, cfg, params=p,
                                param_dtype=torch.bfloat16)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], state.master["w"].to(torch.bfloat16))
    assert not torch.equal(state.master["w"],
                           state.master["w"].to(torch.bfloat16).float())


# -- the reference's tests/test_train.py, on the port ---------------------

def _quad_problem():
    """min ||p - c||^2 — closed-form sanity for AdamW."""
    c = torch.tensor([1.0, -2.0, 3.0])

    def loss(p, x):
        del x
        return torch.sum(torch.square(p["w"] - c))

    params = {"w": torch.zeros(3, requires_grad=True)}
    return loss, params


def test_adamw_converges_on_quadratic_port():
    loss, params = _quad_problem()
    cfg = opt_lib.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                              total_steps=300, min_lr_ratio=1.0)
    state = opt_lib.init(params, cfg)
    step = trainer.make_train_step(loss, cfg)
    for _ in range(300):
        params, state, m = step(params, state, (torch.zeros(()),))
    np.testing.assert_allclose(params["w"].detach().numpy(), [1, -2, 3],
                               atol=1e-2)


def test_grad_accumulation_matches_full_batch_port():
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 2)).astype(np.float32)
    x = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(8, 2)).astype(np.float32))

    def loss(p, x, y):
        return torch.mean(torch.square(x @ p["w"] - y))

    cfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    p1 = {"w": torch.tensor(w0, requires_grad=True)}
    p2 = {"w": torch.tensor(w0, requires_grad=True)}
    s1, s2 = opt_lib.init(p1, cfg), opt_lib.init(p2, cfg)
    full = trainer.make_train_step(loss, cfg, microbatches=1)
    micro = trainer.make_train_step(loss, cfg, microbatches=4)
    p1, _, m1 = full(p1, s1, (x, y))
    p2, _, m2 = micro(p2, s2, (x, y))
    np.testing.assert_allclose(p1["w"].detach().numpy(),
                               p2["w"].detach().numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        trainer.make_train_step(loss, cfg, microbatches=3)(p2, s2, (x, y))


def test_schedule_warmup_and_cosine_port():
    cfg = opt_lib.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                              min_lr_ratio=0.1)
    assert float(opt_lib.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(opt_lib.schedule(cfg, 10)) == pytest.approx(1.0)
    assert float(opt_lib.schedule(cfg, 110)) == pytest.approx(0.1, abs=1e-3)


def test_checkpoint_roundtrip_port(tmp_path):
    """As the reference's, plus a bfloat16 leaf (stored as its uint16
    view) and a NamedTuple; restored in place into the example."""
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.tensor(4.0, dtype=torch.float32)},
            "h": torch.tensor([1.5, -2.25, 3e-3, 65504.0],
                              dtype=torch.bfloat16),
            "o": opt_lib.OptState(torch.tensor(3, dtype=torch.int32),
                                  {"w": torch.ones(2)}, {"w": torch.zeros(2)},
                                  {"w": torch.full((2,), 0.5)})}
    ckpt.save(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    meta = (tmp_path / "step_00000007" / "meta.json").read_text()
    assert '"bfloat16"' in meta
    with np.load(tmp_path / "step_00000007" / "shard_0.npz") as data:
        assert sorted(data[f"a{i}"].dtype.name for i in range(7)) == sorted(
            ["int64", "float32", "uint16", "int32", "float32", "float32",
             "float32"])
    example = {"a": torch.zeros(2, 3, dtype=torch.int64),
               "b": {"c": torch.zeros(())},
               "h": torch.zeros(4, dtype=torch.bfloat16),
               "o": opt_lib.OptState(torch.tensor(0, dtype=torch.int32),
                                     {"w": torch.zeros(2)},
                                     {"w": torch.zeros(2)},
                                     {"w": torch.zeros(2)})}
    got = ckpt.restore(tmp_path, 7, example)
    np.testing.assert_array_equal(got["a"].numpy(), np.arange(6).reshape(2, 3))
    assert float(got["b"]["c"]) == 4.0
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"],
                                                            tree["h"])
    assert isinstance(got["o"], opt_lib.OptState) and int(got["o"].step) == 3
    assert torch.equal(got["o"].v["w"], tree["o"].v["w"])
    assert got["a"] is example["a"]                # filled in place
    with pytest.raises(ValueError, match="another state"):
        ckpt.restore(tmp_path, 7, {"a": torch.zeros(2, 3)})


def test_checkpoint_gc_and_commit_port(tmp_path):
    tree = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        ckpt.save(tmp_path, s, tree, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert steps == ["step_00000003", "step_00000004"]
    # a checkpoint without COMMIT must be invisible
    (tmp_path / "step_00000009").mkdir()
    assert ckpt.latest_step(tmp_path) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path, 9, tree)
    assert not list(tmp_path.glob(".tmp_step_*"))


def test_resumable_run_restart_is_bit_exact_port(tmp_path):
    """Train 20 steps straight vs die-at-12-and-restart: same final params
    (bit for bit here: the same ops on the same device)."""
    loss, _ = _quad_problem()
    cfg = opt_lib.AdamWConfig(lr=0.05, warmup_steps=0, total_steps=100)
    step = trainer.make_train_step(loss, cfg)

    def step_fn(state, batch):
        p, s = state
        p, s, m = step(p, s, batch)
        return (p, s), m

    def fresh():
        _, p = _quad_problem()
        return p, opt_lib.init(p, cfg)

    batches = lambda i: (torch.zeros(()),)

    # run A: straight through
    ra = fault.ResumableRun(str(tmp_path / "a"), checkpoint_every=5)
    sa, _, ha = ra.run(step_fn, fresh(), batches, 20)

    # run B: injected failure at step 12, then restart
    rb = fault.ResumableRun(str(tmp_path / "b"), checkpoint_every=5)
    inj = fault.FailureInjector(fail_at_steps=(12,))
    with pytest.raises(fault.InjectedFailure):
        rb.run(step_fn, fresh(), batches, 20, injector=inj)
    # restart from checkpoint (step 9), replays 10..19
    sb2, done, hb = rb.run(step_fn, fresh(), batches, 20, injector=inj)
    assert done == 10
    assert torch.equal(sa[0]["w"], sb2[0]["w"])
    assert torch.equal(sa[1].master["w"], sb2[1].master["w"])
    assert int(sb2[1].step) == 20
    assert [float(h["loss"]) for h in ha[10:]] == \
        [float(h["loss"]) for h in hb]


def test_straggler_monitor_port():
    mon = fault.StragglerMonitor(threshold=2.0, redistribute_after=2)
    assert not mon.observe(0, 1.0)
    assert not mon.observe(1, 1.1)
    assert mon.observe(2, 5.0)       # straggler
    assert mon.observe(3, 5.0)       # second in a row -> redistribution
    assert mon.redistributions == 1
    assert not mon.observe(4, 1.0)


def test_int8_quantization_error_feedback_port():
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(256,)).astype(np.float32)
    g = torch.from_numpy(g_np)
    q, s = compress.quantize_int8(g)
    want_q, want_s = jcompress.quantize_int8(jnp.asarray(g_np))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    assert float(s) == float(want_s)
    rt = compress.dequantize_int8(q, s)
    assert float(torch.max(torch.abs(rt - g))) <= float(s) * 0.5 + 1e-6
    # error feedback: accumulated compressed updates converge to the truth,
    # each step's codes and residual equal to the reference's
    err = compress.init_error_state({"g": g})["g"]
    jerr = jnp.zeros_like(jnp.asarray(g_np))
    acc = torch.zeros_like(g)
    for _ in range(50):
        sent, err = compress.ef_step(g, err)
        jsent, jerr = jcompress.ef_step(jnp.asarray(g_np), jerr)
        np.testing.assert_array_equal(sent.numpy(), np.asarray(jsent))
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        acc = acc + sent
    np.testing.assert_allclose((acc / 50).numpy(), g_np, atol=float(s))
    np.testing.assert_array_equal(compress.compress_decompress(g).numpy(),
                                  np.asarray(jcompress.compress_decompress(
                                      jnp.asarray(g_np))))


def test_pipeline_is_seekable_and_deterministic_port():
    task = LmSyntheticTask(vocab=1000, seq_len=32, global_batch=4, seed=3)
    a1, t1 = task.batch(5)
    a2, t2 = task.batch(5)
    np.testing.assert_array_equal(a1, a2)
    b1, _ = task.batch(6)
    assert not np.array_equal(a1, b1)
    np.testing.assert_array_equal(t1[:, :-1], a1[:, 1:])


def test_click_task_learnable_signal_port():
    task = ClickSyntheticTask(n_sparse=10, vocab_per_field=100,
                              global_batch=4096)
    ids, labels = task.batch(0)
    assert ids.shape == (4096, 10) and 0.05 < labels.mean() < 0.95
    feat = (ids % 7 == 0).sum(-1)
    # clicks correlate with the latent preference
    assert np.corrcoef(feat, labels)[0, 1] > 0.2


def test_opt_state_convert_rejects_wrong_depth():
    jcfg = jreg.get("llama3-8b").reduced
    params = jax.jit(jt.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    state = jax.tree.map(np.asarray, jopt.init(params, jopt.AdamWConfig()))
    cfg = dataclasses.replace(treg.get("llama3-8b").reduced, n_layers=3)
    with pytest.raises(ValueError, match="stacked layers"):
        convert.opt_state(state, cfg, device="cpu")
