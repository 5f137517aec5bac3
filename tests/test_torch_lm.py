"""The port's LM configs, registry and MoE transformer against the JAX
package's: the reference's ``init_params`` tree carried across by
`repro_torch.convert.transformer_params`, float32 on the CPU.

Tolerances: logits within 1e-4 (the reference's own decode-vs-forward
tolerance is 2e-4), the MoE aux loss within 1e-6, the loss within 1e-5.
The reference runs jitted (one compile per shape instead of one per eager
op)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as tt

LM_ARCHS = ["llama3-8b", "qwen3-8b", "qwen2.5-14b", "qwen3-moe-30b-a3b",
            "granite-moe-3b-a800m"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"]

_init = jax.jit(jt.init_params, static_argnums=1)
_forward = jax.jit(jt.forward, static_argnums=1)
_loss = jax.jit(jt.loss_fn, static_argnums=1)
_prefill = jax.jit(jt.prefill, static_argnums=(1, 3))
_decode = jax.jit(jt.decode_step, static_argnums=1)


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("mesh")
    return d


def _port_cfg(jcfg) -> tt.TransformerConfig:
    return tt.TransformerConfig(**_fields(jcfg))


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_lm(request):
    """(reference params, reference cfg, port model) of the arch's
    reduced (smoke) config."""
    jcfg = jreg.get(request.param).reduced
    params = _init(jax.random.PRNGKey(7), jcfg)
    model = convert.transformer_params(jax.tree.map(np.asarray, params),
                                       treg.get(request.param).reduced,
                                       device="cpu")
    return params, jcfg, model


def test_moe_forward_and_loss_match_reference(moe_lm):
    params, jcfg, model = moe_lm
    tokens = np.random.default_rng(8).integers(
        0, jcfg.vocab, size=(3, 20)).astype(np.int32)
    want, want_aux = _forward(params, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = model.forward(tokens)
    assert got.shape == (3, 20, jcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    targets = np.roll(tokens, -1, axis=1)
    want_loss = float(_loss(params, jcfg, jnp.asarray(tokens),
                            jnp.asarray(targets)))
    with torch.no_grad():
        loss = model.loss(tokens, targets)
    assert abs(float(loss) - want_loss) <= 1e-5


def test_moe_prefill_and_decode_match_reference(moe_lm):
    """Prefill of 10 tokens, then 3 decode steps (capacity 4 at S = 1),
    each against the reference's prefill / decode_step on the same
    tokens."""
    params, jcfg, model = moe_lm
    tokens = np.random.default_rng(9).integers(
        0, jcfg.vocab, size=(2, 13)).astype(np.int32)
    logits, cache = model.prefill(tokens[:, :10], max_len=16)
    want, jcache = _prefill(params, jcfg, jnp.asarray(tokens[:, :10]), 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=0, atol=1e-5)
    for pos in (10, 11, 12):
        lg, cache = model.decode_step(tokens[:, pos:pos + 1], cache)
        jlg, jcache = _decode(params, jcfg, jnp.asarray(tokens[:, pos:pos + 1]),
                              jcache)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=0,
                                   atol=1e-4)
    assert cache["len"] == 13 == int(jcache["len"])


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_reference(arch, which):
    got = getattr(treg.get(arch), which)
    want = getattr(jreg.get(arch), which)
    assert _fields(got) == _fields(want)
    assert got.padded_vocab == want.padded_vocab
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    if want.is_moe:
        assert dataclasses.asdict(got.moe_spec) == \
            dataclasses.asdict(want.moe_spec)
        assert got.moe_spec.capacity(512) == want.moe_spec.capacity(512)


def test_registry_entries_equal_reference():
    for arch in LM_ARCHS + ["remoterag"]:
        got, want = treg.get(arch), jreg.get(arch)
        assert (got.arch_id, got.family) == (want.arch_id, want.family)
        assert got.shapes == {k: type(got.shapes[k])(**dataclasses.asdict(v))
                              for k, v in want.shapes.items()}
        assert got.scan_trip_count() == want.scan_trip_count()
    assert set(treg.REGISTRY) == set(LM_ARCHS + ["remoterag"])


def test_full_lm_configs_match_assignment():
    """The reference's test_full_lm_configs_match_assignment bounds, on the
    port's registry."""
    c = treg.get("llama3-8b").config
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (32, 4096, 32, 8, 14336, 128256)
    c = treg.get("qwen3-8b").config
    assert (c.n_layers, c.d_model, c.d_ff, c.vocab, c.qk_norm) == \
        (36, 4096, 12288, 151936, True)
    c = treg.get("qwen2.5-14b").config
    assert (c.n_layers, c.d_model, c.n_heads, c.d_ff, c.vocab, c.qkv_bias) == \
        (48, 5120, 40, 13824, 152064, True)
    c = treg.get("qwen3-moe-30b-a3b").config
    assert (c.n_layers, c.d_model, c.moe_experts, c.moe_top_k, c.moe_d_ff) == \
        (48, 2048, 128, 8, 768)
    c = treg.get("granite-moe-3b-a800m").config
    assert (c.n_layers, c.d_model, c.moe_experts, c.moe_top_k, c.vocab) == \
        (32, 1536, 40, 8, 49155)
    assert 7e9 < treg.get("llama3-8b").config.param_count() < 9e9
    moe = treg.get("qwen3-moe-30b-a3b").config
    assert 25e9 < moe.param_count() < 36e9
    assert 2e9 < moe.active_param_count() < 4.5e9


@pytest.mark.parametrize("arch,want", [("granite-moe-3b-a800m", 48),
                                       ("qwen3-moe-30b-a3b", 128)])
def test_padded_experts_at_tp16(arch, want):
    cfg = treg.get(arch).config
    assert cfg.tp == 16 and cfg.moe_spec.padded_experts == want
    assert dataclasses.replace(cfg, tp=1).moe_spec.padded_experts == \
        cfg.moe_experts


def test_registry_get_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get("graphcast")


def test_moe_model_has_reference_tree_shapes():
    jcfg = jreg.get("granite-moe-3b-a800m").reduced
    jcfg = dataclasses.replace(jcfg, tp=2)           # 5 experts pad to 6
    ref = jt.abstract_params(jcfg)
    model = tt.Transformer(_port_cfg(jcfg),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    state = model.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            ref["layers"])[0]:
        key = ".".join(p.key for p in path)
        for i in range(jcfg.n_layers):
            assert tuple(state[f"layers.{i}.{key}"].shape) == \
                leaf.shape[1:], key
    assert state["layers.0.moe.w_gate"].shape[0] == 6
    assert not any(".mlp." in k for k in state)


def test_convert_rejects_a_wrong_expert_axis(moe_lm):
    params, jcfg, _ = moe_lm
    tree = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(_port_cfg(jcfg), tp=3)
    assert cfg.moe_spec.padded_experts != jcfg.moe_spec.padded_experts
    with pytest.raises(ValueError, match="expert axes"):
        convert.transformer_params(tree, cfg, device="cpu")


def test_dense_reduced_config_forward_matches_reference():
    """A dense LM named by config (qwen2.5-14b's reduced config, QKV
    bias): its forward.  The dense path itself is held in
    test_torch_models.py."""
    arch = "qwen2.5-14b"
    jcfg = jreg.get(arch).reduced
    params = _init(jax.random.PRNGKey(3), jcfg)
    model = convert.transformer_params(jax.tree.map(np.asarray, params),
                                       treg.get(arch).reduced, device="cpu")
    tokens = np.random.default_rng(10).integers(
        0, jcfg.vocab, size=(2, 8)).astype(np.int32)
    want, _ = _forward(params, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = model.forward(tokens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert float(aux) == 0.0
