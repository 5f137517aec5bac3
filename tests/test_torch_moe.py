"""The port's MoE layer against the JAX package's, float32 on the CPU, on
the same parameters: drawn with numpy at the reference's shapes and
scales, and given to both as arrays.  The reference runs jitted (one
compile per shape instead of one per eager op).

Tolerances: the layer's output within 1e-5 (the expert products and the
combine sum in other orders than XLA's dot and scatter-add), the aux loss
within 1e-6; routing ids exactly."""

import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jm
from repro_torch.models import moe as tm


def _spec_kw(**over):
    kw = dict(d_model=32, d_ff=48, n_experts=6, top_k=2)
    kw.update(over)
    return kw


_ref_fwd = jax.jit(jm.moe_fwd, static_argnums=2)


def _pair(kw, seed=0):
    """(reference params, reference spec, port Moe holding the same
    params, port spec); the params are ``moe_params``' shapes and scales,
    drawn with numpy."""
    jspec, tspec = jm.MoeSpec(**kw), tm.MoeSpec(**kw)
    abstract = jm.moe_params(None, jspec, jnp.float32, True)
    rng = np.random.default_rng(seed)
    d, f = jspec.d_model, jspec.d_ff
    arrays = {k: (rng.normal(size=v.shape) / math.sqrt(
        f if k == "w_down" else d)).astype(np.float32)
        for k, v in abstract.items()}
    mod = tm.Moe(tspec, torch.Generator().manual_seed(0), torch.device("cpu"))
    mod.load_state_dict({k: torch.from_numpy(v.copy())
                         for k, v in arrays.items()}, strict=True)
    return {k: jnp.asarray(v) for k, v in arrays.items()}, jspec, mod, tspec


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@jax.jit
def _ref_logits(x, router):
    return jnp.einsum("bsd,de->bse", x, router).astype(jnp.float32)


def _ref_ids(params, x, spec):
    """The reference's routing lines: einsum, float32, padded experts
    -inf, ``jax.lax.top_k``."""
    logits = _ref_logits(jnp.asarray(x), params["router"])
    e = spec.padded_experts
    if e != spec.n_experts:
        logits = jnp.where((jnp.arange(e) >= spec.n_experts)[None, None, :],
                           -jnp.inf, logits)
    return np.asarray(jax.lax.top_k(logits, spec.top_k)[1])


def _drops(ids, spec, cap):
    """(token, expert) pairs past an expert's capacity in their row."""
    counts = np.stack([np.bincount(r.ravel(), minlength=spec.padded_experts)
                       for r in ids])
    return int(np.maximum(counts - cap, 0).sum())


@pytest.mark.parametrize("ep_pad_to", [1, 4])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("regime", ["prefill", "drop", "decode"])
def test_moe_fwd_matches_reference(ep_pad_to, top_k, regime):
    """Padded experts (6 -> 8 at ep_pad_to 4) are never routed; at
    capacity_factor 0.5 pairs are dropped; S = 1 is decode's capacity."""
    s = 1 if regime == "decode" else 24
    factor = 0.5 if regime == "drop" else 1.25
    params, jspec, mod, tspec = _pair(
        _spec_kw(top_k=top_k, ep_pad_to=ep_pad_to, capacity_factor=factor))
    x = _x((3, s, 32))
    want, want_aux = _ref_fwd(params, jnp.asarray(x), jspec)
    got, aux = tm.moe_fwd(mod, torch.from_numpy(x), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    ids = _ref_ids(params, x, jspec)
    assert (ids < jspec.n_experts).all()
    dropped = _drops(ids, jspec, jspec.capacity(s))
    if regime != "prefill":       # prefill may drop a few pairs, as here
        assert (dropped > 0) == (regime == "drop"), dropped


@pytest.mark.parametrize("ep_pad_to", [1, 4])
def test_router_ids_equal_top_k_with_exact_ties(ep_pad_to):
    """Integer inputs and router make every logit an exact integer, so
    many tie: the port's ids equal ``jax.lax.top_k``'s exactly (value
    desc, lower expert id first), and the layer still matches."""
    kw = _spec_kw(n_experts=6, top_k=3, ep_pad_to=ep_pad_to)
    params, jspec, mod, tspec = _pair(kw)
    rng = np.random.default_rng(2)
    router = rng.integers(-2, 3, size=(32, jspec.padded_experts))
    params = dict(params, router=jnp.asarray(router, jnp.float32))
    mod.router.data = torch.from_numpy(router.astype(np.float32))
    x = rng.integers(-1, 2, size=(2, 16, 32)).astype(np.float32)
    _, values, ids = tm.route(mod, torch.from_numpy(x), tspec)
    want = _ref_ids(params, x, jspec)
    np.testing.assert_array_equal(ids[..., :3].numpy(), want)
    assert (values[..., 2] == values[..., 3]).any()      # ties at the cut
    want_out, _ = _ref_fwd(params, jnp.asarray(x), jspec)
    got, _ = tm.moe_fwd(mod, torch.from_numpy(x), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=0,
                               atol=1e-5)


def test_moe_forward_shape_and_aux():
    """The reference's test_moe_forward_and_aux, on the port."""
    spec = tm.MoeSpec(d_model=32, d_ff=64, n_experts=6, top_k=2, ep_pad_to=4)
    assert spec.padded_experts == 8
    mod = tm.Moe(spec, torch.Generator().manual_seed(0), torch.device("cpu"))
    x = torch.from_numpy(_x((2, 10, 32)))
    out, aux = tm.moe_fwd(mod, x, spec)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux) > 0


def test_moe_capacity_drops_gracefully():
    spec = tm.MoeSpec(d_model=16, d_ff=16, n_experts=2, top_k=1,
                      capacity_factor=0.5)
    mod = tm.Moe(spec, torch.Generator().manual_seed(0), torch.device("cpu"))
    out, _ = tm.moe_fwd(mod, torch.from_numpy(_x((1, 64, 16))), spec)
    assert torch.isfinite(out).all()
    assert (out.abs().sum(-1) == 0).any()          # dropped tokens add 0


def test_moe_matches_dense_expert_computation():
    """With E = 1, k = 1 and huge capacity, MoE == its single expert's
    MLP."""
    spec = tm.MoeSpec(d_model=16, d_ff=32, n_experts=1, top_k=1,
                      capacity_factor=4.0)
    mod = tm.Moe(spec, torch.Generator().manual_seed(5), torch.device("cpu"))
    x = torch.from_numpy(_x((2, 8, 16), seed=6))
    out, _ = tm.moe_fwd(mod, x, spec)
    h = torch.nn.functional.silu(x @ mod.w_gate[0]) * (x @ mod.w_up[0])
    torch.testing.assert_close(out, h @ mod.w_down[0], rtol=1e-4, atol=1e-5)


def test_moe_fwd_is_bit_reproducible():
    _, _, mod, spec = _pair(_spec_kw(capacity_factor=0.5))
    x = torch.from_numpy(_x((3, 24, 32)))
    a, aux_a = tm.moe_fwd(mod, x, spec)
    b, aux_b = tm.moe_fwd(mod, x, spec)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.parametrize("ep_pad_to", [1, 4])
def test_dispatch_over_expert_halves_sums_to_layer(ep_pad_to):
    """`_dispatch_compute` on experts [0, E/2) and [E/2, E), each with its
    own weights only, adds up to the whole layer's output (the expert-
    shard computation the multi-device slice will run per shard)."""
    _, _, mod, spec = _pair(_spec_kw(ep_pad_to=ep_pad_to,
                                     capacity_factor=0.5))
    x = torch.from_numpy(_x((3, 24, 32)))
    whole, _ = tm.moe_fwd(mod, x, spec)
    _, values, ids = tm.route(mod, x, spec)
    gate_i = ids[..., :spec.top_k]
    gate_w = torch.softmax(values[..., :spec.top_k], dim=-1)
    e, cap = spec.padded_experts, spec.capacity(x.shape[1])
    parts = []
    for lo in (0, e // 2):
        w = types.SimpleNamespace(
            **{n: getattr(mod, n)[lo:lo + e // 2]
               for n in ("w_gate", "w_up", "w_down")})
        parts.append(tm._dispatch_compute(w, x, gate_w, gate_i, lo, e // 2,
                                          cap, spec))
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=0, atol=1e-6)
    assert parts[0].abs().sum() > 0 and parts[1].abs().sum() > 0


def test_shard_a2a_with_a_mesh_raises():
    spec = tm.MoeSpec(**_spec_kw(impl="shard_a2a", mesh=object()))
    mod = tm.Moe(spec, torch.Generator().manual_seed(0), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 2"):
        tm.moe_fwd(mod, torch.from_numpy(_x((1, 4, 32))), spec)
