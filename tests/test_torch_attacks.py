"""The port's text front end (hash tokenizer, token corpus) and
embedding-inversion attacks against the JAX package's, on the CPU (the
score-top-k kernel's plain version decodes the nearest neighbour), plus
the reference's own attack properties (tests/test_attacks.py) held for the
port.

Tolerances: tokenizer ids and the token corpus are equal (same integer
arithmetic, same numpy draws in the same order).  The nearest neighbour's
decoded ids are equal up to ties: where they differ, the port's row must
score within 1e-5 of the reference's best under the reference's float64
scores (float32 kernel scoring).  The linear decoder's W solves a float32
ridge system whose condition number is ~3e4 here, so two float32 solves
(LAPACK through numpy, LAPACK through torch) agree normwise, not
elementwise: the test holds W to the reference within 1e-3 relative
(Frobenius; measured 1.05e-4) and to a backward error of 1e-6, its token
sets equal where the m-th/(m+1)-th logit gap exceeds 1e-4, and its curves
within 0.02."""

import numpy as np
import pytest
import torch

from repro.core import attacks as ja
from repro.data import synth as js
from repro.data import tokenizer as jtok
from repro_torch.core import attacks as ta
from repro_torch.data import synth as ts
from repro_torch.data import tokenizer as ttok

RADII = [0.0, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 4.0]
TEXTS = ["rain and storms this weekend",
         "Stock MARKET crash Bond",
         "Café naïve Ünïcode 東京 test — émoji 🙂",
         "  leading   and trailing\twhitespace\n",
         ""]


@pytest.fixture(scope="module")
def corpus():
    """test_attacks.py's corpus (600 docs x 256, vocab 512), built by the
    port; test_token_corpus_equals_reference holds it to the reference's."""
    return ts.token_corpus(np.random.default_rng(0), 600, 256, vocab=512,
                           doc_len=16)


@pytest.fixture(scope="module")
def paraphrased():
    """Fig. 4's corpus shape (paraphrase clusters) at a test size."""
    return ts.token_corpus(np.random.default_rng(7), 800, 256, vocab=1024,
                           doc_len=20, paraphrases=15)


@pytest.mark.parametrize("vocab", [512, 8192, 32768])
@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_equal_reference(text, vocab):
    jt, tt = jtok.HashTokenizer(vocab), ttok.HashTokenizer(vocab)
    for kw in ({}, {"bos": False}, {"eos": True}):
        assert tt.encode(text, **kw) == jt.encode(text, **kw)
    assert tt.encode(text.upper()) == jt.encode(text.lower())
    assert (ttok.PAD, ttok.BOS, ttok.EOS, ttok.UNK, ttok.RESERVED) == (
        jtok.PAD, jtok.BOS, jtok.EOS, jtok.UNK, jtok.RESERVED)


@pytest.mark.parametrize("seq", [1, 4, 32])
def test_encode_batch_truncates_after_bos_like_reference(seq):
    jt, tt = jtok.HashTokenizer(8192), ttok.HashTokenizer(8192)
    got = tt.encode_batch(TEXTS, seq)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), seq)
    np.testing.assert_array_equal(got, jt.encode_batch(TEXTS, seq))
    assert (got[:, 0] == ttok.BOS).all()


def test_tokenizer_rejects_a_vocab_without_room():
    with pytest.raises(ValueError):
        ttok.HashTokenizer(ttok.RESERVED)


@pytest.mark.parametrize("kw", [dict(vocab=512, doc_len=16),
                                dict(vocab=1024, doc_len=20, paraphrases=15),
                                dict(vocab=300, doc_len=8, paraphrases=3,
                                     swap_frac=0.5, zipf_a=1.6)])
def test_token_corpus_equals_reference(kw):
    want = js.token_corpus(np.random.default_rng(0), 600, 256, **kw)
    got = ts.token_corpus(np.random.default_rng(0), 600, 256, **kw)
    assert got.embeddings.dtype == np.float32
    np.testing.assert_array_equal(got.embeddings, want.embeddings)
    np.testing.assert_array_equal(got.projection, want.projection)
    assert got.token_sets == want.token_sets
    assert got.documents == want.documents and got.vocab == want.vocab
    toks = sorted(want.token_sets[3])
    np.testing.assert_array_equal(got.embed_tokens(toks),
                                  want.embed_tokens(toks))


@pytest.mark.parametrize("pred,true", [({1, 2, 3}, {1, 2, 3}), ({1, 2}, {3, 4}),
                                       ({1, 2, 3, 4}, {1, 2}), (set(), {1}),
                                       ({5, 6, 7}, {7, 8, 9, 10, 5})])
def test_token_f1_equals_reference(pred, true):
    assert ta.token_f1(pred, true) == ja.token_f1(pred, true)


def _ref_nn_scores(corpus, obs):
    return np.stack([corpus.embeddings @ js.unit(o) for o in obs])


def test_nn_decode_ids_equal_reference_up_to_ties(paraphrased):
    obs = ta.perturbed_queries(paraphrased, range(60), RADII,
                               np.random.default_rng(1))
    jatk = ja.NearestNeighborAttack(aux=paraphrased)
    want = np.asarray([jatk.decode_index(o) for o in obs])
    got = ta.NearestNeighborAttack(aux=paraphrased,
                                   device="cpu").decode_indices(obs)
    scores = _ref_nn_scores(paraphrased, obs)
    rows = np.arange(len(obs))
    assert (scores[rows, want] - scores[rows, got] <= 1e-5).all()
    assert (got == want).mean() > 0.99


def test_nn_curves_equal_reference(paraphrased):
    jatk = ja.NearestNeighborAttack(aux=paraphrased)
    tatk = ta.NearestNeighborAttack(aux=paraphrased, device="cpu")
    for curve in ("exact_recovery_curve", "attack_curve"):
        want = getattr(ja, curve)(jatk, paraphrased, range(50), RADII,
                                  np.random.default_rng(2))
        got = getattr(ta, curve)(tatk, paraphrased, range(50), RADII,
                                 np.random.default_rng(2))
        np.testing.assert_array_equal(got, want)


def test_perturbed_queries_are_the_reference_curves_draws(corpus):
    """The batch is drawn radius outer, query inner: after it the caller's
    generator is where the reference's curve leaves it."""
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    obs = ta.perturbed_queries(corpus, [4, 9], [0.0, 0.5], a)
    for i, (r, qi) in enumerate([(0.0, 4), (0.0, 9), (0.5, 4), (0.5, 9)]):
        e = corpus.embeddings[qi]
        np.testing.assert_array_equal(obs[i],
                                      e + r * js.unit(b.normal(size=e.shape)))
    assert a.normal() == b.normal()


@pytest.fixture(scope="module")
def linear(corpus):
    return (ja.LinearDecoderAttack(aux=corpus, top_m=16),
            ta.LinearDecoderAttack(aux=corpus, top_m=16, device="cpu"))


def test_linear_decoder_weights_match_reference(corpus, linear):
    jatk, tatk = linear
    W = tatk.W.numpy()
    assert W.dtype == np.float32 and W.shape == jatk.W.shape
    assert np.linalg.norm(W - jatk.W) / np.linalg.norm(jatk.W) < 1e-3
    X = corpus.embeddings.astype(np.float64)
    Y = np.zeros((X.shape[0], corpus.vocab))
    for i, toks in enumerate(corpus.token_sets):
        Y[i, list(toks)] = 1.0
    gram = X.T @ X + 1e-2 * np.eye(X.shape[1])
    backward = (np.linalg.norm(gram @ W - X.T @ Y)
                / (np.linalg.norm(gram) * np.linalg.norm(W)))
    assert backward < 1e-6


def test_linear_decoder_sets_equal_reference_outside_ties(corpus, linear):
    jatk, tatk = linear
    obs = ta.perturbed_queries(corpus, range(40), [0.0, 0.5, 4.0],
                               np.random.default_rng(4))
    logits = np.stack([js.unit(o) @ jatk.W for o in obs])
    srt = -np.sort(-logits, axis=1)
    clear = srt[:, 15] - srt[:, 16] > 1e-4
    want = [jatk.reconstruct(o) for o in obs]
    got = tatk.reconstruct_batch(obs)
    assert clear.sum() > 0.9 * len(obs)
    for w, g, c in zip(want, got, clear):
        assert len(g) == 16
        if c:
            assert g == w
    assert tatk.reconstruct(obs[0]) == got[0]


def test_linear_decoder_curve_matches_reference(paraphrased):
    want = ja.attack_curve(ja.LinearDecoderAttack(aux=paraphrased, top_m=20),
                           paraphrased, range(50), RADII,
                           np.random.default_rng(5))
    got = ta.attack_curve(ta.LinearDecoderAttack(aux=paraphrased, top_m=20,
                                                 device="cpu"),
                          paraphrased, range(50), RADII,
                          np.random.default_rng(5))
    assert np.abs(got - want).max() <= 0.02


# -- test_attacks.py's properties, held for the port ----------------------

def test_nn_attack_perfect_at_zero_perturbation(corpus):
    atk = ta.NearestNeighborAttack(aux=corpus, device="cpu")
    scores = [atk.score(corpus.embeddings[i], corpus.token_sets[i])
              for i in range(20)]
    assert np.mean(scores) > 0.95


def test_attack_curve_monotone_decay(corpus):
    atk = ta.NearestNeighborAttack(aux=corpus, device="cpu")
    curve = ta.attack_curve(atk, corpus, range(30), [0.0, 0.5, 4.0, 10.0],
                            np.random.default_rng(1))
    assert curve[0] > 0.9
    assert curve[-1] < 0.6 * curve[0]
    assert curve[0] >= curve[2] >= curve[3]


def test_exact_recovery_cliffs_before_f1(corpus):
    rng = np.random.default_rng(5)
    atk = ta.NearestNeighborAttack(aux=corpus, device="cpu")
    exact = ta.exact_recovery_curve(atk, corpus, range(30), [0.0, 1.0], rng)
    f1 = ta.attack_curve(atk, corpus, range(30), [0.0, 1.0], rng)
    assert exact[0] == 1.0
    assert exact[1] <= f1[1] + 1e-9


def test_linear_decoder_recovers_tokens_and_decays(corpus, linear):
    _, atk = linear
    s = [atk.score(corpus.embeddings[i], corpus.token_sets[i])
         for i in range(20)]
    assert np.mean(s) > 0.3
    curve = ta.attack_curve(atk, corpus, range(20), [0.0, 4.0],
                            np.random.default_rng(2))
    assert curve[1] < 0.75 * curve[0]


def test_attacks_hold_their_state_on_the_device(corpus, linear):
    _, lin = linear
    nn = ta.NearestNeighborAttack(aux=corpus, device="cpu")
    assert isinstance(nn.embeddings, torch.Tensor)
    assert nn.embeddings.device.type == lin.W.device.type == "cpu"
