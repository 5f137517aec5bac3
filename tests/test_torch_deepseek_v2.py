"""DeepSeek-V2-Lite on the port's LM path against its plain reference
(``rag_bench/reference/deepseek_v2.py``; the JAX package has no latent
attention), float32 on the CPU at `deepseek_v2_lite.REDUCED` (1 dense + 2
MoE layers, 8 experts top-3, latent 32), weights drawn by name from one
seed on both sides; then the benchmark's generator program through
``harness.run_cell`` at a tiny size, whole and with its timed path broken.

Tolerances: logits within 1e-4 (float32 products summed in other orders
over at most 3 layers; measured ~3e-6), a MoE layer within 1e-5 (one
layer), absorbed against expanded attention within 1e-5 (the same sums
regrouped through the latent), YaRN's frequencies and scales within
float32's rounding of the same formula (1e-7 relative)."""

import dataclasses
import io
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rag_bench import harness, lm_counts  # noqa: E402
from rag_bench.reference import deepseek_v2 as ref  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as dsv2  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            init_by_name)
from repro_torch.serve.generate import Generator  # noqa: E402

SEED = 2**31 + 101
HF = dsv2.REDUCED_HF


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return init_by_name(Transformer(dsv2.REDUCED, device="meta"), SEED,
                        "cpu")


def _ref_weights(seed=SEED):
    return ref.Weights(HF, seed, "cpu", served=torch.float32,
                       compute=torch.float32)


def _tokens(shape, seed=3):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, HF["vocab_size"], size=shape))


def test_weights_drawn_by_name_are_the_references():
    m = init_by_name(Transformer(dsv2.REDUCED, device="meta"), SEED, "cpu")
    params = dict(m.named_parameters())
    tables = [ref.outer_shapes(HF)] + [ref.layer_shapes(HF, i) for i in
                                       range(HF["num_hidden_layers"])]
    names = {name: shape for t in tables for name, shape in t.values()}
    assert set(names) == set(params)
    for name, shape in names.items():
        assert tuple(params[name].shape) == shape, name
        want = ref.draw(SEED, name, shape, "cpu", torch.float32)
        assert torch.equal(params[name], want), name


def test_published_config_counts():
    """15.71 B parameters (attention 13.77 M a layer, the dense layer
    67.2 M, a MoE layer 571.1 M, embedding and head 419.4 M)."""
    c = dsv2.CONFIG
    assert c.n_layers == 27 and c.moe_experts == 64 and c.vocab == 102400
    assert [c.layer_is_moe(i) for i in (0, 1, 26)] == [False, True, True]
    assert c.moe_spec.shared_d_ff == 2816 and c.moe_spec.dropless
    assert c.param_count() == 15_706_484_224
    assert abs(c.param_count() * 2 / 1e9 - 31.4) < 0.05
    assert dsv2.from_hf(dsv2.HF_CONFIG) == c
    with pytest.raises(ValueError, match="q_lora_rank"):
        dsv2.from_hf({**dsv2.HF_CONFIG, "q_lora_rank": 1536})
    with pytest.raises(ValueError, match="norm_topk_prob"):
        dsv2.from_hf({**dsv2.HF_CONFIG, "norm_topk_prob": True})


def test_the_benchmark_configuration_is_the_published_one():
    """The cell's configuration file holds every key of `HF_CONFIG`
    (the published config.json) with the same value."""
    import json

    with open(ROOT / "rag_bench" / "configs" / "deepseek-v2-lite.json") as f:
        cfg = json.load(f)
    assert {k: cfg.get(k) for k in dsv2.HF_CONFIG} == dsv2.HF_CONFIG
    assert cfg["reduced"] == []


def test_yarn_at_the_published_numbers():
    spec = dsv2.CONFIG.mla_spec
    y = spec.rope_scaling
    assert (y.factor, y.original_max_position, y.beta_fast, y.beta_slow) == \
        (40, 4096, 32, 1)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert layers.yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-12)
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert spec.softmax_scale() == pytest.approx(192 ** -0.5 * m * m,
                                                 rel=1e-12)
    assert spec.rope_mscale() == 1.0
    freqs = layers.yarn_freqs(64, 10000.0, y)
    plain = 1.0 / 10000.0 ** (torch.arange(0, 64, 2).double() / 64)
    # pairs turning more than 32 times over 4096 positions keep the plain
    # rope (dims 0-9), fewer than once are divided by 40 (23-31)
    np.testing.assert_allclose(freqs[:10], plain[:10], rtol=1e-6)
    np.testing.assert_allclose(freqs[23:], plain[23:] / 40, rtol=1e-6)
    assert torch.all((freqs[10:23] < plain[10:23]) &
                     (freqs[10:23] > plain[10:23] / 40))
    np.testing.assert_allclose(freqs, ref.rope_inv_freq(dsv2.HF_CONFIG,
                                                        "cpu"), rtol=1e-7)
    assert ref.softmax_scale(dsv2.HF_CONFIG) == pytest.approx(
        spec.softmax_scale(), rel=1e-12)


def test_rope_follows_the_interleaved_layout():
    x = torch.randn(2, 5, 3, 8)
    pos = torch.arange(5)[None]
    freqs = layers.yarn_freqs(8, 10000.0, None)
    got = layers.rope_interleaved(x, pos, freqs)
    want = ref.apply_rotary(x[0], pos[0], {"qk_rope_head_dim": 8,
                                           "rope_theta": 10000})
    torch.testing.assert_close(got[0], want, rtol=0, atol=1e-6)


def test_gate_softmax_over_all_experts_topk_not_renormalised(model):
    p = model.layers[1].moe
    x = torch.randn(7, HF["hidden_size"])
    w, ids = moe.softmax_topk_gates(p, x, p.spec)
    scores = torch.softmax(x.double() @ p.router.double(), dim=-1)
    want_w, want_i = torch.topk(scores, HF["num_experts_per_tok"], dim=-1)
    assert torch.equal(ids, want_i)
    torch.testing.assert_close(w.double(), want_w, rtol=1e-6, atol=0)
    assert torch.all(w.sum(-1) < 1)


@pytest.mark.parametrize("grouped", [True, False])
def test_dropless_moe_against_a_per_expert_loop(model, grouped,
                                                monkeypatch):
    """Every token shares a direction u, and expert 2's router column is
    u scaled to a logit near 10, so every token picks expert 2: the
    capacity path would drop half of its pairs; the dropless one equals
    the reference's per-expert loop."""
    if not grouped:
        monkeypatch.setattr(moe, "_GROUPED_MM", None)
    p = model.layers[1].moe
    u = torch.randn(HF["hidden_size"])
    x = torch.randn(2, 16, HF["hidden_size"]) + u
    router = p.router.clone()
    router[:, 2] = u * 10 / u.square().sum()
    monkeypatch.setattr(p, "router", torch.nn.Parameter(router,
                                                        requires_grad=False))
    _, ids = moe.softmax_topk_gates(p, x.reshape(32, -1), p.spec)
    assert bool((ids == 2).any(-1).all())
    assert p.spec.capacity(16) < 16          # einsum path: at most 8 of 16
    got, aux = moe.moe_fwd(p, x, p.spec)
    w = {"gate": p.router, "experts.gate_proj": p.w_gate,
         "experts.up_proj": p.w_up, "experts.down_proj": p.w_down,
         "shared_experts.gate_proj": p.shared.w_gate,
         "shared_experts.up_proj": p.shared.w_up,
         "shared_experts.down_proj": p.shared.w_down}
    want = ref.moe(x.reshape(32, -1), w, HF).reshape(x.shape)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert float(aux) == 0.0
    capped = moe.moe_fwd_einsum(p, x, p.spec)[0]
    assert (capped - want).abs().max() > 1e-2


def test_prefill_logits_match_the_reference(model):
    tokens = _tokens((2, 20))
    logits, _ = model.prefill(tokens, 24)
    want = ref.forward(HF, _ref_weights(), tokens, torch.arange(20))
    torch.testing.assert_close(logits[..., :HF["vocab_size"]], want, rtol=0,
                               atol=1e-4)
    last, cache = model.prefill(tokens, 24, last_only=True)
    torch.testing.assert_close(last, logits[:, -1], rtol=0, atol=1e-6)
    assert set(cache) == {"ckv", "kpe", "len"} and cache["len"] == 20
    assert cache["ckv"].shape == (3, 2, 24, HF["kv_lora_rank"])
    assert cache["kpe"].shape == (3, 2, 24, HF["qk_rope_head_dim"])


def test_decode_through_the_latent_cache_matches_the_full_forward(model):
    tokens = _tokens((3, 26), seed=4)
    want = ref.forward(HF, _ref_weights(), tokens, torch.arange(26))
    logits, cache = model.prefill(tokens[:, :16], 26)
    torch.testing.assert_close(logits[..., :HF["vocab_size"]], want[:, :16],
                               rtol=0, atol=1e-4)
    for pos in range(16, 26):
        lg, cache = model.decode_step(tokens[:, pos:pos + 1], cache)
        torch.testing.assert_close(lg[:, :HF["vocab_size"]], want[:, pos],
                                   rtol=0, atol=1e-4)
    assert cache["len"] == 26


def test_decode_reads_a_device_side_cache_length(model):
    """A 0-d tensor as ``cache["len"]`` (what a CUDA graph replays) gives
    the int's logits and cache, for latent attention and for GQA."""
    from repro_torch.configs import qwen3_moe_30b_a3b
    gqa = Transformer(qwen3_moe_30b_a3b.REDUCED, device="cpu",
                      generator=torch.Generator().manual_seed(3))
    for m in (model, gqa):
        tokens = _tokens((2, 12), seed=6) % m.cfg.vocab
        _, c_int = m.prefill(tokens[:, :10], 12)
        _, c_t = m.prefill(tokens[:, :10], 12)
        c_t["len"] = torch.tensor(10)
        for pos in (10, 11):
            a, c_int = m.decode_step(tokens[:, pos:pos + 1], c_int)
            b, c_t = m.decode_step(tokens[:, pos:pos + 1], c_t)
            assert torch.equal(a, b)
        assert int(c_t["len"]) == c_int["len"] == 12
        for key in m.cache_keys:
            assert torch.equal(c_int[key], c_t[key])


def test_absorbed_decode_equals_expanded_attention(model):
    attn = model.layers[1].attn
    spec = attn.spec
    x = torch.randn(2, 12, HF["hidden_size"])
    pos = torch.arange(12)[None]
    full, (latent, k_pe) = layers.mla_fwd(attn, x, spec, positions=pos)
    c = torch.zeros(2, 12, spec.kv_lora_rank)
    pe = torch.zeros(2, 12, spec.qk_rope_dim)
    c[:, :9], pe[:, :9] = latent[:, :9], k_pe[:, :9]
    # three new tokens at once (causal among them), then one
    out3, _ = layers.mla_fwd(attn, x[:, 9:11], spec, positions=pos[:, 9:11],
                             cache=(c, pe, 9))
    out1, _ = layers.mla_fwd(attn, x[:, 11:], spec, positions=pos[:, 11:],
                             cache=(c, pe, 11))
    torch.testing.assert_close(torch.cat([out3, out1], 1), full[:, 9:],
                               rtol=0, atol=1e-5)
    # the cache holds what the full pass computed, up to the rounding of
    # products of other shapes
    torch.testing.assert_close(c, latent, rtol=0, atol=1e-6)
    torch.testing.assert_close(pe, k_pe, rtol=0, atol=1e-6)


def test_generator_serves_static_greedy_batches(model):
    gen = Generator(model, max_batch=3, answer_len=4)
    pool = _tokens((5, 10), seed=5).to(torch.int32)
    rids = [gen.submit("t", p) for p in pool]
    assert gen.pending == 5
    first = []
    while not first:
        first = gen.step()
    assert [r.request_id for r in first] == rids[:3] and gen.pending == 2
    rest = gen.drain()
    assert [r.request_id for r in rest] == rids[3:] and gen.pending == 0
    for r in first + rest:
        assert r.ok and r.tokens.dtype == np.int32 and r.tokens.shape == (4,)
        assert r.transcript.total_bytes == 4 * (10 + 4)
    # the served tokens are the reference's greedy ones, with its logits
    toks, lgs = ref.greedy(HF, _ref_weights(), pool[:3], 4)
    assert np.array_equal(np.stack([r.tokens for r in first]), toks.numpy())
    np.testing.assert_allclose(np.stack([r.logits for r in first]),
                               lgs.numpy(), rtol=0, atol=1e-4)


def test_counts_at_the_published_widths():
    """A batch's prefill ~368 TFLOP; a decode step's least bytes ~19.9 GB
    with 34.9 experts a layer (64·(1 − (58/64)^8))."""
    c = dsv2.HF_CONFIG
    assert lm_counts.prefill_flops(c, 8, 8192) / 1e12 == pytest.approx(
        368, rel=0.01)
    touched = 64 * (1 - (58 / 64) ** 8)
    assert lm_counts.decode_bytes(c, 8, 8192 + 32, touched) / 1e9 == \
        pytest.approx(19.9, rel=0.01)
    # the decode step is byte-bound by far
    assert (lm_counts.decode_flops(c, 8, 8224) / lm_counts.BF16_FLOPS_S
            < 0.1 * lm_counts.decode_bytes(c, 8, 8224, touched) / 3.35e12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graphed decode step)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_decode_equals_eager_decode_on_the_card(cuda, dtype):
    """The generator's decode step (a CUDA graph in bfloat16, eager in
    float32) gives the eager loop's tokens and logits bit for bit, the
    graph's cache reused by a second batch; traced, it records every
    layer's device spans and the expert count."""
    from rag_bench import devtrace
    from repro_torch import obs

    cfg = dataclasses.replace(dsv2.REDUCED, dtype=dtype)
    m = init_by_name(Transformer(cfg, device="meta"), SEED, cuda)
    pool = _tokens((6, 20), seed=7).to(cuda, torch.int32)
    tracer = devtrace.stage_tracer(obs, __import__("time").perf_counter)
    tracer.open = True
    for tr in (None, tracer):
        gen = Generator(m, max_batch=3, answer_len=5, tracer=tr)
        for p in pool:
            gen.submit("t", p)
        got = gen.drain()
        for rows in (slice(0, 3), slice(3, 6)):
            logits, cache = m.prefill(pool[rows], 25, last_only=True)
            toks, lgs = [], []
            for _ in range(5):
                nxt = logits[:, :HF["vocab_size"]].argmax(-1)
                toks.append(nxt)
                lgs.append(logits.gather(1, nxt[:, None])[:, 0].float())
                logits, cache = m.decode_step(nxt[:, None], cache)
            want_t = torch.stack(toks, 1).cpu().numpy()
            want_l = torch.stack(lgs, 1).cpu().numpy()
            assert np.array_equal(np.stack([r.tokens for r in got[rows]]),
                                  want_t)
            assert np.array_equal(np.stack([r.logits for r in got[rows]]),
                                  want_l)
    steps = tracer.count["decode_device"]
    assert steps == 8 and tracer.count["prefill_device"] == 2
    assert tracer.count["mla_device"] == 3 * steps
    assert tracer.count["moe_device"] == 2 * steps
    assert tracer.count["mlp_device"] == steps
    assert tracer.count["experts_touched"] == steps
    layer_s = sum(tracer.seconds[k] for k in ("mla_device", "moe_device",
                                              "mlp_device"))
    assert 0 < layer_s <= tracer.seconds["decode_device"]


GEN_METRICS = ("prefill_device_ms.gen", "decode_device_ms.gen",
               "mla_decode_ms.gen", "moe_decode_ms.gen",
               "experts_touched.gen", "step_mfu.gen", "decode_roofline.gen",
               "device_idle_share.gen")


def test_the_generator_metrics_read_its_spans():
    """Each reader against the arithmetic by hand over a made-up window
    (one prefill of 8, two decode steps), and nothing where the window
    holds none of its spans."""
    from rag_bench import devtrace, manifest
    from repro_torch import obs

    def run_of(tracer, device=None):
        return harness.Run(seconds=1.0, setup_s=0.0, tracer=tracer,
                           device=device,
                           shapes=dict(model=dsv2.HF_CONFIG, prompt_len=8192,
                                       answer_len=64, moe_layers=26))

    read = {m: manifest.load_module("metrics", m).read for m in GEN_METRICS}
    empty = devtrace.stage_tracer(obs, lambda: 0.0)
    assert all(read[m](run_of(None)) is None for m in GEN_METRICS)
    assert all(read[m](run_of(empty)) is None for m in GEN_METRICS)

    t = devtrace.stage_tracer(obs, lambda: 0.0)
    t.open = True
    t.record("prefill_device", 0.0, 1.2, lanes=8)
    for j in range(2):
        t.record("decode_device", 0.0, 0.01, lanes=8)
        for _ in range(27):
            t.record("mla_device", 0.0, 0.0002, lanes=8)
        t.record("mlp_device", 0.0, 0.0001, lanes=8)
        for _ in range(26):
            t.record("moe_device", 0.0, 0.0002, lanes=8)
        t.record("experts_touched", 0.0, 0.0, count=26 * (34 + j))
    got = {m: read[m](run_of(t, dict(busy_s=0.75, window_s=1.0)))
           for m in GEN_METRICS}
    assert got["prefill_device_ms.gen"] == pytest.approx(150.0)
    assert got["decode_device_ms.gen"] == pytest.approx(10.0)
    assert got["mla_decode_ms.gen"] == pytest.approx(5.4)
    assert got["moe_decode_ms.gen"] == pytest.approx(5.2)
    assert got["experts_touched.gen"] == pytest.approx(34.5)
    c = dsv2.HF_CONFIG
    flops = (lm_counts.prefill_flops(c, 8, 8192)
             + 2 * lm_counts.decode_flops(c, 8, 8192 + 32))
    assert got["step_mfu.gen"] == pytest.approx(
        100 * flops / (1.22 * 989.4e12))
    assert got["decode_roofline.gen"] == pytest.approx(
        100 * 2 * lm_counts.decode_bytes(c, 8, 8224, 34.5) / 3.35e12 / 0.02)
    assert got["device_idle_share.gen"] == pytest.approx(25.0)


# ---------------------------------------------------------------------------
# the benchmark's program through the harness
# ---------------------------------------------------------------------------

TINY = {**{k: HF[k] for k in (
    "num_hidden_layers", "hidden_size", "intermediate_size",
    "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
    "num_attention_heads", "num_key_value_heads", "kv_lora_rank",
    "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "vocab_size")},
    # 16 experts top-2: near the published share of experts a token uses
    # (6 of 64), which the renormalising break scales
    "n_routed_experts": 16, "num_experts_per_tok": 2,
    "precision": "float32",
    "serving": {"prompt_len": 24, "answer_len": 6, "max_batch": 4,
                "pool": 16}}


def _run(fault=None, seed=2**31 + 77):
    return harness.run_cell("dsv2lite-rag8k", seed=seed, seconds=1.0,
                            trace=False, device="cpu", config_overrides=TINY,
                            fault=fault, log=io.StringIO())


def _failing(out):
    return {n for n, c in out["checks"].items() if c["value"] > c["limit"]}


def test_the_generator_cell_runs_correct():
    out = _run()
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 16
    assert list(out["checks"]) == ["missing", "wire_errors", "token_gap",
                                   "logit_err"]
    assert out["metrics"]["wire_kb_per_request"]["value"] == 0.12
    assert out["checks"]["logit_err"]["value"] < 1e-4


def _no_shared(mp):
    mp.setattr(moe, "mlp_fwd", lambda p, x: torch.zeros_like(x))


def _no_mscale(mp):
    mp.setattr(layers.MlaSpec, "softmax_scale",
               lambda self: self.q_head_dim ** -0.5)


def _renormalised(mp):
    gates = moe.softmax_topk_gates

    def renorm(*args):
        w, ids = gates(*args)
        return w / w.sum(-1, keepdim=True), ids
    mp.setattr(moe, "softmax_topk_gates", renorm)


def _position_off_by_one(mp):
    step = transformer.Transformer.decode_step

    def shifted(self, tokens, cache, **kw):
        lg, c = step(self, tokens, {**cache, "len": cache["len"] + 1}, **kw)
        return lg, {**c, "len": c["len"] - 1}
    mp.setattr(transformer.Transformer, "decode_step", shifted)


def _latent_norm_weight_dropped(mp):
    norm = layers.rms_norm

    def unweighted(x, scale, *args, **kw):
        if scale.shape == (TINY["kv_lora_rank"],):
            scale = torch.ones_like(scale)
        return norm(x, scale, *args, **kw)
    mp.setattr(layers, "rms_norm", unweighted)


@pytest.mark.parametrize("brk", [_no_shared, _no_mscale, _renormalised,
                                 _position_off_by_one,
                                 _latent_norm_weight_dropped])
def test_a_broken_timed_path_is_not_correct(brk, monkeypatch):
    out = _run(fault=lambda program: brk(monkeypatch))
    assert not out["correct"]
    assert _failing(out) & {"token_gap", "logit_err"}


def test_the_control_reads_the_runs_numbers():
    """``rag_bench/lm_control.py`` at the tiny size: the served weights
    rounded to float8 e4m3 through the harness's fault hook, read by the
    run's own comparison, come out not correct."""
    from rag_bench import lm_control

    out = lm_control.readings("dsv2lite-rag8k", 2**31 + 5, seconds=1.0,
                              device="cpu", config_overrides=TINY)
    assert out["attempted"] >= 16
    assert not out["correct"]
    assert out["checks"]["logit_err"] > out["limits"]["logit_err"] or \
        out["checks"]["token_gap"] > out["limits"]["token_gap"]
