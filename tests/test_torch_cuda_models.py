"""The port's model paths on the card against the same weights on the CPU:
the Fig. 4 inversion attacks, the MoE LM's bfloat16 serving, training at
Llama-3-8B's width and its fault drill, graphcast, and the recsys models.

Marked ``cuda``: on a host without a CUDA device every test here skips.
Float32 comparisons run with TF32 off; the training tolerances are the
loss within 1e-5 relative and every gradient within 1e-4 normwise.  None
of these paths launches a kernel of ours.
"""

import copy
import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from test_torch_cuda_serving import launches

# the fault drill runs under torch.use_deterministic_algorithms, whose
# cuBLAS calls need a fixed workspace, set before cuBLAS starts (test
# modules are imported before any test runs)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

pytestmark = pytest.mark.cuda

LOSS_RTOL, GRAD_RTOL, MASTER_RTOL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def no_tf32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def rel_err(got, want) -> float:
    """||got - want|| / ||want|| in float64, on ``got``'s device."""
    want = want.to(got.device).double()
    den = float(want.norm())
    return (float((got.double() - want).norm()) / den if den
            else float(got.double().norm()))


def assert_grads_close(loss, grads, want_loss, want_grads):
    """Loss within LOSS_RTOL relative; every gradient finite and within
    GRAD_RTOL normwise."""
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        assert rel_err(g, want_grads[k]) <= GRAD_RTOL, k


# -- the Fig. 4 inversion attacks ---------------------------------------------

RADII = (0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 4.0)
FIG4_DOCS, FIG4_QUERIES = 3000, 50


def test_fig4_curves_on_card_equal_cpu(cuda):
    """Fig. 4's full setting (``token_corpus`` 3000 x 768, vocab 1024, 20
    tokens, 15 paraphrases; 50 queries; radii 0 to 4): the exact-recovery,
    NN F1 and linear-decoder curves on the card (score-top-k launched) and
    through the plain CPU path from a copy of the generator.  Every curve
    non-increasing within 0.05, exact recovery 1.0 at r = 0, the linear
    curves within 0.02 of each other, and the NN decode's ids equal up to
    rows scoring within 1e-5 (float64) of each other."""
    from repro_torch.core import attacks
    from repro_torch.data import synth

    rng = np.random.default_rng(0)
    corpus = synth.token_corpus(rng, FIG4_DOCS, 768, vocab=1024, doc_len=20,
                                paraphrases=15)
    rng_cpu = copy.deepcopy(rng)

    def curves(device, gen):
        nn = attacks.NearestNeighborAttack(aux=corpus, device=device)
        exact = attacks.exact_recovery_curve(nn, corpus, range(FIG4_QUERIES),
                                             RADII, gen)
        f1 = attacks.attack_curve(nn, corpus, range(FIG4_QUERIES), RADII,
                                  gen)
        lin = attacks.LinearDecoderAttack(aux=corpus, top_m=20,
                                          device=device)
        lin_f1 = attacks.attack_curve(lin, corpus, range(FIG4_QUERIES),
                                      RADII, gen)
        return dict(exact=exact.tolist(), nn_f1=f1.tolist(),
                    linear_f1=lin_f1.tolist()), nn

    (card, nn), counts = launches(lambda: curves(cuda, rng))
    assert counts.get("score_topk", 0) > 0, counts
    cpu, nn_cpu = curves(torch.device("cpu"), rng_cpu)
    for name, c in card.items():
        assert all(c[i + 1] <= c[i] + 0.05 for i in range(len(c) - 1)), (
            name, c)
    assert card["exact"][0] == 1.0
    assert max(abs(a - b) for a, b in zip(card["linear_f1"],
                                          cpu["linear_f1"])) <= 0.02
    obs = attacks.perturbed_queries(corpus, range(FIG4_QUERIES), RADII,
                                    np.random.default_rng(5))
    got, want = nn.decode_indices(obs), nn_cpu.decode_indices(obs)
    e64 = corpus.embeddings.astype(np.float64)
    u = synth.unit(obs)
    assert np.abs((e64[got] * u).sum(-1) - (e64[want] * u).sum(-1)).max() \
        <= 1e-5


# -- the MoE LM ----------------------------------------------------------------

def test_moe_lm_bf16_prefill_and_decode_repeat_on_card(cuda):
    """Qwen3-30B-A3B at every published width with tp = 1, 8 of its 48
    layers in bfloat16 (5.61 B parameters, drawn on the card): 8 prompts x
    512 tokens through ``prefill`` twice, bit for bit and finite; 64
    greedy ``decode_step``s twice from copies of the prefill's cache, the
    same ids, every id inside the vocabulary, finite logits."""
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(registry.get("qwen3-moe-30b-a3b").config,
                              tp=1, n_layers=8)
    model = Transformer(cfg, generator=torch.Generator(device=cuda)
                        .manual_seed(0), device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab, size=(8, 512))).to(cuda)

    def run():
        logits, cache = model.prefill(tokens, max_len=1024)
        again, _ = model.prefill(tokens, max_len=1024)
        assert bool(torch.isfinite(logits).all())
        assert torch.equal(logits, again)
        last = logits[:, -1].clone()
        del logits, again

        def decode():
            c = {"k": cache["k"].clone(), "v": cache["v"].clone(),
                 "len": cache["len"]}
            nxt = last[..., :cfg.vocab].argmax(-1)
            ids, finite = [], []
            for _ in range(64):
                lg, c = model.decode_step(nxt[:, None], c)
                nxt = lg[..., :cfg.vocab].argmax(-1)
                ids.append(nxt)
                finite.append(torch.isfinite(lg).all())
            assert bool(torch.stack(finite).all())
            return torch.stack(ids, dim=1)

        return decode(), decode()

    (a, b), counts = launches(run)
    assert counts == {}
    assert bool((a < cfg.vocab).all()) and torch.equal(a, b)


# -- training -------------------------------------------------------------------

def test_train_full_width_grads_and_adamw_card_equal_cpu(cuda, no_tf32):
    """Llama-3-8B at every published width with tp = 1, 2 of its 32 layers
    in float32: one set of weights drawn on the CPU and loaded on the card;
    one 1 x 256 ``LmSyntheticTask`` batch through the loss and its
    gradients on both, then two AdamW ``apply``s of those gradients: the
    loss and every gradient within the training tolerances, every master
    within 1e-5 normwise, the step count 2."""
    from repro_torch.data.pipeline import LmSyntheticTask
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    cfg = dataclasses.replace(registry.get("llama3-8b").config, tp=1,
                              n_layers=2, dtype="float32")
    batch = LmSyntheticTask(vocab=cfg.vocab, seq_len=256, global_batch=1,
                            seed=0).batch(0)
    ocfg = opt_lib.AdamWConfig()

    def run(model):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        tokens, targets = (torch.from_numpy(b).to(model.device)
                           for b in batch)
        loss, grads = trainer.value_and_grad(
            lambda p, x, y: model.loss(x, y), params, (tokens, targets))
        state = opt_lib.init(params, ocfg)
        for _ in range(2):
            _, state, _ = opt_lib.apply(grads, state, ocfg, params=params)
        float(loss)                                   # waits for the device
        return loss, grads, state

    cpu = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    card = Transformer(cfg, generator=torch.Generator(device=cuda)
                       .manual_seed(0), device=cuda)
    card.load_state_dict(cpu.state_dict())
    want_loss, want_grads, want_state = run(cpu)
    del cpu
    (loss, grads, state), counts = launches(lambda: run(card))
    assert counts == {}
    assert_grads_close(loss, grads, want_loss, want_grads)
    for k, m in state.master.items():
        assert rel_err(m, want_state.master[k]) <= MASTER_RTOL, k
    assert int(state.step) == 2


def test_train_bf16_full_width_steps_on_card(cuda):
    """Llama-3-8B at every published width with tp = 1, 4 of its 32 layers:
    bfloat16 parameters with a float32 master, m and v, remat on;
    ``make_lm_run`` over 8 x 4096 tokens a step in 8 microbatches: finite
    losses and gradient norms."""
    from repro_torch.launch.train import make_lm_run

    cfg = dataclasses.replace(registry.get("llama3-8b").config, tp=1,
                              n_layers=4)
    assert cfg.remat and cfg.dtype == "bfloat16" and cfg.tp == 1
    step_fn, batches_fn, state = make_lm_run(
        cfg, batch=8, seq=4096, lr=3e-4, steps=2, microbatches=8,
        device=cuda, seed=0)

    def steps():
        nonlocal state
        out = []
        for i in range(2):
            state, m = step_fn(state, batches_fn(i))
            out.append(m)
        return out

    hist, counts = launches(steps)
    assert counts == {}
    assert all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist), hist


def test_train_lm_drill_resumes_bit_for_bit_on_card(cuda, deterministic,
                                                    tmp_path):
    """``examples/train_lm.py``'s config_100m, 90 steps of 8 x 256 with a
    checkpoint every 30, straight through and again through the example's
    drill (a failure at step 30, a restart from the newest checkpoint),
    under deterministic algorithms: the resumed history and state equal
    the uninterrupted run's bit for bit, and the last loss lies below the
    first."""
    from repro_torch.examples import train_lm
    from repro_torch.launch.train import make_lm_run
    from repro_torch.train import checkpoint, fault

    cfg = train_lm.config_100m()
    steps, every, fail_at = 90, 30, 30

    def both():
        step_fn, batches_fn, state = make_lm_run(
            cfg, batch=8, seq=256, lr=3e-3, steps=steps, device=cuda, seed=0)
        run = fault.ResumableRun(str(tmp_path / "straight"),
                                 checkpoint_every=every)
        straight = run.run(step_fn, state, batches_fn, steps)
        resumed = train_lm.drill(
            cfg, steps=steps, batch=8, seq=256,
            ckpt_dir=str(tmp_path / "drill"), ckpt_every=every,
            fail_at=fail_at, device=cuda)
        return straight, resumed

    ((state_a, done_a, hist_a), (state_b, done_b, hist_b, _)), counts = \
        launches(both)
    assert counts == {}
    assert done_a == steps and done_b == steps - fail_at
    keys = ("loss", "grad_norm", "lr")
    assert ([[h[k] for k in keys] for h in hist_b]
            == [[h[k] for k in keys] for h in hist_a[fail_at:]])
    leaves = [[t for _, t in checkpoint._flatten(s)]
              for s in (state_a, state_b)]
    assert all(torch.equal(a, b) for a, b in zip(*leaves))
    first, last = hist_a[0]["loss"], hist_b[-1]["loss"]
    assert math.isfinite(last) and last < first


# -- graphcast -------------------------------------------------------------------

GNN_NODES, GNN_IN_DEG = 232_965, 50     # Reddit's nodes; in-degree cut


@pytest.fixture(scope="module")
def host_graph():
    """A synthetic host graph of Reddit's 232,965 nodes with 50 in-edges
    each from uniform sources (cut from Reddit's ~492: only the sampled
    subgraph reaches the card); its in-neighbour CSR."""
    from repro_torch.models import gnn

    rng = np.random.default_rng(30)
    dst = np.repeat(np.arange(GNN_NODES), GNN_IN_DEG)
    src = rng.integers(0, GNN_NODES, dst.shape[0])
    return gnn.build_csr(src, dst, GNN_NODES)


def gnn_batch(device, rng, n_nodes, src, dst, d_feat, n_vars,
              pad_nodes=None, pad_edges=None):
    """A `GraphBatch`: seeded features and targets for ``n_nodes`` nodes
    and the edges (src, dst), padded to ``pad_nodes`` / ``pad_edges`` (a
    shape's static bounds: zero-feature nodes, the pad edges self-loops
    spread over them)."""
    from repro_torch.models import gnn

    v, e = pad_nodes or n_nodes, pad_edges or len(src)
    assert v >= n_nodes + (e > len(src)) and e >= len(src)
    feats = np.zeros((v, d_feat), np.float32)
    feats[:n_nodes] = rng.normal(size=(n_nodes, d_feat))
    loops = n_nodes + np.arange(e - len(src)) % max(v - n_nodes, 1)
    s = np.concatenate([src, loops]).astype(np.int32)
    d = np.concatenate([dst, loops]).astype(np.int32)
    tgt = rng.normal(size=(v, n_vars)).astype(np.float32)
    return gnn.GraphBatch(*(torch.from_numpy(x).to(device)
                            for x in (feats, s, d, tgt)))


def test_gnn_on_card_equals_cpu(cuda, no_tf32, host_graph):
    """graphcast at every published width, 2 of its 16 layers in float32,
    on a 12-seed fanout subgraph of ``minibatch_lg``: the loss and every
    gradient on the card within the training tolerances of the CPU's, also
    under deterministic algorithms, where two runs agree bit for bit (the
    scatters' float atomics otherwise order a node's messages freely)."""
    from repro_torch.configs import graphcast, shapes
    from repro_torch.models import gnn
    from repro_torch.train import trainer

    shape = shapes.GNN_SHAPES["minibatch_lg"]
    cfg = dataclasses.replace(graphcast.CONFIG, n_layers=2, dtype="float32",
                              d_feat=shape.d_feat)
    rng = np.random.default_rng(31)
    nodes, src, dst = gnn.sample_fanout(
        rng, *host_graph, rng.choice(GNN_NODES, 12, replace=False),
        shape.fanout)
    batch = gnn_batch(cuda, rng, len(nodes), src, dst, cfg.d_feat,
                      cfg.n_vars)
    cpu = gnn.Gnn(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    card = gnn.Gnn(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())

    def run(model, b):
        model.requires_grad_(True)
        return trainer.value_and_grad(
            lambda p, *x: model.loss(gnn.GraphBatch(*x)),
            dict(model.named_parameters()), tuple(b))

    want_loss, want = run(cpu, gnn.GraphBatch(*(t.cpu() for t in batch)))
    (loss, grads), counts = launches(lambda: run(card, batch))
    assert counts == {}
    assert_grads_close(loss, grads, want_loss, want)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det_loss, det = run(card, batch)
        again_loss, again = run(card, batch)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(det_loss, again_loss)
    assert all(torch.equal(det[k], again[k]) for k in det)
    assert_grads_close(det_loss, det, want_loss, want)


@pytest.mark.parametrize("name", ["minibatch_lg", "full_graph_sm",
                                  "molecule"])
def test_gnn_bf16_steps_on_card(cuda, host_graph, name):
    """graphcast at every published width (16 bfloat16 layers, remat, the
    shape's d_feat) drawn on the card, two AdamW steps: finite losses.
    ``minibatch_lg`` on a 1024-seed fanout (15, 10) subgraph of the host
    graph padded to the shape's bounds; ``full_graph_sm`` and ``molecule``
    on uniform random graphs of their sizes."""
    from repro_torch.configs import graphcast, shapes
    from repro_torch.models import gnn
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    shape = shapes.GNN_SHAPES[name]
    rng = np.random.default_rng(32)
    n_vars = graphcast.CONFIG.n_vars
    if name == "minibatch_lg":
        nodes, src, dst = gnn.sample_fanout(
            rng, *host_graph, rng.choice(GNN_NODES, 1024, replace=False),
            shape.fanout)
        batch = gnn_batch(cuda, rng, len(nodes), src, dst, shape.d_feat,
                          n_vars, shape.n_nodes, shape.n_edges)
    else:
        src = rng.integers(0, shape.n_nodes, shape.n_edges).astype(np.int32)
        dst = rng.integers(0, shape.n_nodes, shape.n_edges).astype(np.int32)
        batch = gnn_batch(cuda, rng, shape.n_nodes, src, dst, shape.d_feat,
                          n_vars)
    cfg = dataclasses.replace(graphcast.CONFIG, d_feat=shape.d_feat)
    model = gnn.Gnn(cfg, generator=torch.Generator(device=cuda)
                    .manual_seed(0), device=cuda)
    params = dict(model.requires_grad_(True).named_parameters())
    ocfg = opt_lib.AdamWConfig()
    step = trainer.make_train_step(
        lambda p, *x: model.loss(gnn.GraphBatch(*x)), ocfg,
        param_dtype=cfg.torch_dtype)

    def steps():
        state, losses = opt_lib.init(params, ocfg), []
        for _ in range(2):
            _, state, m = step(params, state, tuple(batch))
            losses.append(float(m["loss"]))
        return losses

    losses, counts = launches(steps)
    assert counts == {}
    assert all(math.isfinite(x) for x in losses), losses


# -- recsys ----------------------------------------------------------------------

REC_SERVE, REC_TRAIN, TWOTOWER_TRAIN, DIEN_MICRO = 512, 65_536, 32_768, 4


def recsys_inputs(rng, arch, cfg, b):
    """A seeded batch of ``arch``'s inputs at batch ``b`` (numpy): ids per
    field within the field's vocabulary, offset globally; labels last."""
    lbl = rng.integers(0, 2, b).astype(np.float32)
    if arch in ("fm", "dcn-v2"):
        ids = (rng.integers(0, cfg.vocab_per_field, (b, cfg.n_sparse))
               + np.arange(cfg.n_sparse) * cfg.vocab_per_field)
        ids = ids.astype(np.int32)
        if arch == "fm":
            return ids, lbl
        return rng.normal(size=(b, cfg.n_dense)).astype(np.float32), ids, lbl
    if arch == "dien":
        return (rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)).astype(
            np.int32), rng.integers(0, cfg.item_vocab, b).astype(np.int32),
            lbl)
    return (rng.integers(0, cfg.user_vocab, (b, cfg.n_user_feats)).astype(
        np.int32), rng.integers(0, cfg.item_vocab,
                                (b, cfg.n_item_feats)).astype(np.int32))


@pytest.mark.parametrize("arch", ["fm", "dcn-v2", "dien",
                                  "two-tower-retrieval"])
def test_recsys_on_card_equals_cpu(cuda, no_tf32, arch):
    """A recsys model at its published widths and vocabularies: from one
    CPU weight set, the loss and every gradient of a batch of 256 on the
    card within the training tolerances of the CPU's; the forward at
    ``serve_p99``'s batch of 512, finite; two AdamW steps at
    ``train_batch`` (two-tower's cut to 32,768 by its in-batch logits,
    DIEN's in 4 microbatches), finite."""
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    cfg = registry.get(arch).config
    rng = np.random.default_rng(40)
    cpu = recsys.MODELS[arch](cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    card = recsys.MODELS[arch](cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = recsys_inputs(rng, arch, cfg, 256)

    def grads(model, b):
        model.requires_grad_(True)
        return trainer.value_and_grad(lambda p, *x: model.loss(*x),
                                      dict(model.named_parameters()), b)

    want_loss, want = grads(cpu, tuple(torch.from_numpy(x) for x in batch))
    del cpu
    serve = tuple(torch.from_numpy(x).to(cuda)
                  for x in recsys_inputs(rng, arch, cfg, REC_SERVE))
    inputs = serve if arch == "two-tower-retrieval" else serve[:-1]
    b = TWOTOWER_TRAIN if arch == "two-tower-retrieval" else REC_TRAIN
    micro = DIEN_MICRO if arch == "dien" else 1
    train = tuple(torch.from_numpy(x).to(cuda)
                  for x in recsys_inputs(rng, arch, cfg, b))

    def run():
        loss, got = grads(card, tuple(torch.from_numpy(x).to(cuda)
                                      for x in batch))
        card.requires_grad_(False)
        with torch.no_grad():
            scores = card(*inputs)
        params = dict(card.requires_grad_(True).named_parameters())
        ocfg = opt_lib.AdamWConfig()
        state = opt_lib.init(params, ocfg)
        step = trainer.make_train_step(lambda p, *x: card.loss(*x), ocfg,
                                       microbatches=micro,
                                       param_dtype=cfg.torch_dtype)
        losses = []
        for _ in range(2):
            _, state, m = step(params, state, train)
            losses.append(float(m["loss"]))
        return loss, got, scores, losses

    (loss, got, scores, losses), counts = launches(run)
    assert counts == {}
    assert_grads_close(loss, got, want_loss, want)
    assert tuple(scores.shape) == (REC_SERVE,)
    assert bool(torch.isfinite(scores).all())
    assert all(math.isfinite(x) for x in losses), losses
