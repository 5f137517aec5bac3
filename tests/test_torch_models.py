"""The port's transformer layers, dense transformer and text embedder
against the JAX package's, with the reference's parameters carried across
by `repro_torch.convert` (``jax.random`` cannot be replayed in torch).

Tolerances: elementwise float32 ops (rms_norm, RoPE) within 1e-6; the
attention within 1e-5 (sums in other orders); a whole forward within 1e-4
(the reference's own decode-vs-forward tolerance is 2e-4)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import embedder as jemb
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.models import embedder as temb
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab=997, d_head=16, dtype="float32", remat=False,
            kv_chunk=32)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.fixture(scope="module")
def tiny():
    """(reference params, reference cfg, port model) of a 2-layer GQA LM."""
    jcfg = jt.TransformerConfig(**TINY)
    params = jt.init_params(jax.random.PRNGKey(1), jcfg)
    model = convert.transformer_params(jax.tree.map(np.asarray, params),
                                       tt.TransformerConfig(**TINY),
                                       device="cpu")
    return params, jcfg, model


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.normal(size=(16,)).astype(np.float32)
    want = _np(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(scale)).numpy(), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("theta", [500_000.0, 10_000.0])
def test_apply_rope_rotates_halves_like_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :] + 3
    want = _np(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = tl.apply_rope(_t(x), _t(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl.rope_freqs(16, theta).numpy(),
                               _np(jl.rope_freqs(16, theta)), rtol=1e-7)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,kv_chunk", [(40, 16), (12, 1024)])
def test_chunked_attention_matches_reference(causal, s, kv_chunk):
    """Several chunks with a padded last one (40 = 16 + 16 + 8), and one
    short KV; GQA with 2 query heads per KV head."""
    rng = np.random.default_rng(2)
    b, hq, hkv, d = 2, 4, 2, 16
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    want = _np(jl.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    kv_chunk=kv_chunk))
    got = tl.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               kv_chunk=kv_chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_direct_attention_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 20, 2, 16)).astype(np.float32)
    want = _np(jl.direct_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_offset=11, kv_len=12))
    got = tl.direct_attention(_t(q), _t(k), _t(v), q_offset=11,
                              kv_len=12).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tp,heads,kv", [(8, 4, 2), (2, 4, 2), (4, 8, 2),
                                         (16, 40, 8), (16, 24, 8), (1, 6, 6)])
def test_tp_head_padding_arithmetic_matches_reference(tp, heads, kv):
    kw = dict(d_model=heads * 16, n_heads=heads, n_kv_heads=kv, d_head=16,
              tp_pad_to=tp)
    js, ts = jl.AttentionSpec(**kw), tl.AttentionSpec(**kw)
    assert (ts.padded_heads, ts.padded_kv_heads) == (js.padded_heads,
                                                     js.padded_kv_heads)
    np.testing.assert_array_equal(ts.kv_head_source(), js.kv_head_source())


def test_init_has_reference_shapes_and_scales():
    jcfg = jt.TransformerConfig(**TINY)
    ref = jt.abstract_params(jcfg)
    model = tt.Transformer(tt.TransformerConfig(**TINY),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    state = model.state_dict()
    assert tuple(state["embed"].shape) == ref["embed"].shape
    assert tuple(state["unembed"].shape) == ref["unembed"].shape
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            ref["layers"])[0]:
        key = ".".join(p.key for p in path)
        for i in range(TINY["n_layers"]):
            assert tuple(state[f"layers.{i}.{key}"].shape) == \
                leaf.shape[1:], key
    # normal x 1/sqrt(fan-in): wq's std ~ 1/8; norms are ones
    assert abs(float(state["layers.0.attn.wq"].std()) - 1 / 8) < 0.01
    assert torch.equal(state["layers.1.mlp_norm"], torch.ones(64))
    again = tt.Transformer(tt.TransformerConfig(**TINY),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in state.items())


def test_forward_and_loss_match_reference(tiny):
    params, jcfg, model = tiny
    tokens = np.random.default_rng(4).integers(0, 997, size=(2, 12)).astype(
        np.int32)
    want, _ = jt.forward(params, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got, aux = model.forward(tokens)
    assert got.shape == (2, 12, jcfg.padded_vocab) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-4)
    targets = np.roll(tokens, -1, axis=1)
    want_loss = float(jt.loss_fn(params, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(targets)))
    with torch.no_grad():
        loss = model.loss(tokens, targets)
    assert abs(float(loss) - want_loss) < 1e-4


def test_prefill_and_decode_match_forward(tiny):
    """Prefill + two decode steps agree with the full forward on the same
    tokens (the reference's test_transformer_decode_matches_forward), and
    the decoded logits with the reference's decode."""
    params, jcfg, model = tiny
    tokens = np.random.default_rng(5).integers(0, 997, size=(1, 12)).astype(
        np.int32)
    with torch.no_grad():
        full, _ = model.forward(tokens)
    logits_pre, cache = model.prefill(tokens[:, :8], max_len=16)
    np.testing.assert_allclose(logits_pre.numpy(), full[:, :8].numpy(),
                               rtol=2e-4, atol=2e-4)
    _, jcache = jt.prefill(params, jcfg, jnp.asarray(tokens[:, :8]),
                           max_len=16)
    np.testing.assert_allclose(cache["k"].numpy(), _np(jcache["k"]),
                               rtol=0, atol=1e-5)
    for pos in (8, 9):
        lg, cache = model.decode_step(tokens[:, pos:pos + 1], cache)
        np.testing.assert_allclose(lg.numpy(), full[:, pos].numpy(),
                                   rtol=2e-4, atol=2e-4)
        jlg, jcache = jt.decode_step(params, jcfg,
                                     jnp.asarray(tokens[:, pos:pos + 1]),
                                     jcache)
        np.testing.assert_allclose(lg.numpy(), _np(jlg), rtol=0, atol=1e-4)
    assert cache["len"] == 10


@pytest.mark.parametrize("dim", [128, 256])
@pytest.mark.parametrize("masked", [False, True])
def test_embed_matches_reference(dim, masked):
    """At dim 256 the heads span 2 x 256 (max(4, dim // 128) heads of 128):
    hq·d != d_model."""
    jcfg = jemb.encoder_config(dim=dim, vocab=512, n_layers=2)
    tcfg = temb.encoder_config(dim=dim, vocab=512, n_layers=2)
    assert tcfg == tt.TransformerConfig(**{
        f: getattr(jcfg, f) for f in tt.TransformerConfig.__dataclass_fields__})
    params = jemb.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.embedder(jax.tree.map(np.asarray, params), tcfg,
                             device="cpu")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 512, size=(3, 10)).astype(np.int32)
    mask = (rng.random((3, 10)) < 0.7).astype(np.float32) if masked else None
    want = _np(jemb.embed(params, jcfg, jnp.asarray(tokens),
                          None if mask is None else jnp.asarray(mask)))
    got = model.embed(tokens, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_convert_rejects_a_tree_of_another_depth(tiny):
    params, _, _ = tiny
    with pytest.raises(ValueError, match="stacked layers"):
        convert.transformer_params(
            jax.tree.map(np.asarray, params),
            tt.TransformerConfig(**dict(TINY, n_layers=3)), device="cpu")
