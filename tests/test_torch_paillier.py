"""The port's Paillier backend on the CPU against the JAX package's.

The object path (``repro.crypto.paillier``, host integers) runs here as it
is and is the oracle: keys, ciphertexts and decryptions of the port's
object path and of its vectorized twin (`repro_torch.crypto.paillier_vec`,
RNS Montgomery tensor ops) must equal it bit for bit under shared numpy
seeds.  The reference's vectorized Paillier needs
``jax.experimental.enable_x64``, which the installed JAX no longer has;
one subprocess runs it with ``JAX_ENABLE_X64=1`` and that attribute set to
``contextlib.nullcontext`` (the shim never touches this process), together
with one reference ``run_remoterag(backend="paillier")`` round, and two
tests hold the port to what it printed.  Keys are 256-bit (24 channels),
1024-bit (90 channels, the object fallback) where the boundary is tested.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.crypto import paillier as jpai
from repro.data import synth
from repro_torch import convert
from repro_torch.core import protocol
from repro_torch.crypto import backend as backends
from repro_torch.crypto import paillier as pai
from repro_torch.crypto import paillier_vec as pvec
from repro_torch.kernels.bignum import ref

ROOT = Path(__file__).resolve().parents[1]
DIM, KPRIME = 48, 12
CPU = "cpu"


@pytest.fixture
def one_thread():
    """One intra-op thread for the Paillier path's many small CPU ops:
    beside other busy test workers a thread-parallel region costs
    milliseconds an op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


def _unit(rng, *shape):
    x = rng.normal(size=shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _keys(n, bits=256):
    return [pai.keygen(bits, rng=np.random.default_rng(100 + i))
            for i in range(n)]


def _jkey(sk):
    """The reference's key with the same integers (its keygen under the
    same seed gives them: `test_object_path_matches_reference`)."""
    pub = jpai.PaillierPublicKey(n=sk.pub.n, n_sq=sk.pub.n_sq, g=sk.pub.g)
    return jpai.PaillierSecretKey(pub=pub, lam=sk.lam, mu=sk.mu)


# -- object path: a copy of the reference's ---------------------------------


def test_object_path_matches_reference():
    rng = np.random.default_rng(0)
    e = _unit(rng, DIM)
    cands = _unit(rng, KPRIME, DIM)
    sk = pai.keygen(256, rng=np.random.default_rng(5))
    jsk = jpai.keygen(256, rng=np.random.default_rng(5))
    assert (sk.pub.n, sk.pub.n_sq, sk.pub.g, sk.lam, sk.mu) == (
        jsk.pub.n, jsk.pub.n_sq, jsk.pub.g, jsk.lam, jsk.mu)
    assert sk.pub.key_bits == jsk.pub.key_bits
    assert sk.pub.ciphertext_bytes() == jsk.pub.ciphertext_bytes()
    assert pai.encode_vector(e, sk.pub.n) == jpai.encode_vector(e, jsk.pub.n)
    enc = pai.encrypt_vector(sk.pub, e, rng=np.random.default_rng(6))
    assert enc == jpai.encrypt_vector(jsk.pub, e, rng=np.random.default_rng(6))
    cts = pai.encrypted_scores(sk.pub, enc, cands, rng=np.random.default_rng(7))
    assert cts == jpai.encrypted_scores(jsk.pub, enc, cands,
                                        rng=np.random.default_rng(7))
    got = pai.decrypt_scores(sk, cts)
    np.testing.assert_array_equal(got, jpai.decrypt_scores(jsk, cts))
    np.testing.assert_allclose(got, cands @ e, atol=2e-3)
    c = pai.encrypted_dot(sk.pub, enc, cands[0])
    assert pai._decode(pai.decrypt(sk, c), sk.pub.n, 2 * pai.FRAC_BITS) == \
        pytest.approx(float(cands[0] @ e), abs=2e-3)


def test_object_path_homomorphisms():
    sk = _keys(1)[0]
    n = sk.pub.n
    for m in (0, 1, 42, n - 1, n // 2):
        assert pai.decrypt(sk, pai.encrypt(sk.pub, m)) == m % n
    c = pai.add(sk.pub, pai.encrypt(sk.pub, 1234), pai.encrypt(sk.pub, 4321))
    assert pai.decrypt(sk, c) == 5555
    assert pai.decrypt(sk, pai.mul_plain(sk.pub, pai.encrypt(sk.pub, 77),
                                         13)) == 1001
    assert pai.decrypt(sk, pai.mul_plain(sk.pub, pai.encrypt(sk.pub, 77),
                                         -13)) == (-1001) % n
    assert pai.encrypt(sk.pub, 5) != pai.encrypt(sk.pub, 5)   # secrets


# -- vectorized Paillier against the object path ----------------------------


def test_vec_encrypt_wire_parity():
    """Same seed -> the vectorized encryptor emits the identical
    ciphertext integers as the reference's object path."""
    sk = _keys(1)[0]
    e = _unit(np.random.default_rng(5), DIM)
    got = pvec.encrypt_vector(sk.pub, e, rng=np.random.default_rng(42),
                              device=CPU)
    want = jpai.encrypt_vector(_jkey(sk).pub, e,
                               rng=np.random.default_rng(42))
    assert got == want


def test_vec_scores_wire_parity():
    """Per-lane seeded blinding: the batched RNS score path equals
    per-lane object calls, lanes of different keys in one call; candidates
    may be float32 tensors (the index's rows)."""
    keys = _keys(3)
    rng = np.random.default_rng(6)
    queries = _unit(rng, 3, DIM)
    cands = [torch.from_numpy(_unit(rng, KPRIME, DIM)).float() for _ in keys]
    enc = [jpai.encrypt_vector(_jkey(k).pub, q, rng=np.random.default_rng(7 + i))
           for i, (k, q) in enumerate(zip(keys, queries))]
    want = [jpai.encrypted_scores(_jkey(k).pub, e, c.numpy(),
                                  rng=np.random.default_rng(50 + i))
            for i, (k, e, c) in enumerate(zip(keys, enc, cands))]
    got = pvec.encrypted_scores_batch(
        [k.pub for k in keys], enc, cands,
        rngs=[np.random.default_rng(50 + i) for i in range(3)], device=CPU)
    assert got == want


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_vec_decrypt_bit_exact_across_batch_sizes(batch):
    """Vectorized score + vectorized decrypt == the reference's object
    score + object decrypt, element-exact, and within 2e-3 of the
    plaintext inner products."""
    keys = _keys(batch)
    rng = np.random.default_rng(batch)
    queries = _unit(rng, batch, DIM)
    cands = [_unit(rng, KPRIME, DIM) for _ in keys]
    enc = [jpai.encrypt_vector(_jkey(k).pub, q, rng=np.random.default_rng(9))
           for k, q in zip(keys, queries)]
    pvec.reset_counters()
    cts = pvec.encrypted_scores_batch([k.pub for k in keys], enc, cands,
                                      device=CPU)
    got = pvec.decrypt_scores_batch(keys, cts, device=CPU)
    assert pvec.counters == {"vectorized": 2 * batch, "object": 0}
    for k, e, c, g, q in zip(keys, enc, cands, got, queries):
        obj = jpai.decrypt_scores(_jkey(k), jpai.encrypted_scores(
            _jkey(k).pub, e, c))
        np.testing.assert_array_equal(g, obj)
        assert g.shape == (KPRIME,)
        np.testing.assert_allclose(g, c @ q, atol=2e-3)


def test_negative_scalars_use_the_inverse_table():
    """Negative fixed-point scalars (the inverse-ciphertext table) and
    exact zeros: bit-exact against the object path, and the reference's
    exact-value case."""
    sk = _keys(1)[0]
    q = np.array([-0.5, 0.5, -0.5, 0.5])
    c = np.array([[0.5, 0.5, 0.5, 0.5], [-0.5, 0.0, 0.5, -0.25],
                  [-0.125, -0.5, -0.75, -0.125]])
    enc = pvec.encrypt_vector(sk.pub, q, rng=np.random.default_rng(1),
                              device=CPU)
    cts = pvec.encrypted_scores_batch([sk.pub], [enc], [c],
                                      rngs=[np.random.default_rng(2)],
                                      device=CPU)[0]
    assert cts == jpai.encrypted_scores(_jkey(sk).pub, enc, c,
                                        rng=np.random.default_rng(2))
    got = pvec.decrypt_scores_batch([sk], [cts], device=CPU)[0]
    np.testing.assert_array_equal(got, c @ q)
    assert got[0] == 0.0


def test_oversized_key_selects_object_path():
    """A 1024-bit key needs 90 channels, over the 64-channel budget: every
    stage takes the object path for that lane, counted, while a 256-bit
    lane in the same batch stays vectorized; results stay exact."""
    big = pai.keygen(1024, rng=np.random.default_rng(0))
    small = _keys(1)[0]
    assert ref.num_channels(big.pub.n_sq) == 90
    assert not pvec.fits(big.pub) and pvec.fits(small.pub)
    dim = 16
    rng = np.random.default_rng(2)
    queries = _unit(rng, 2, dim)
    cands = [_unit(rng, 6, dim) for _ in range(2)]
    pvec.reset_counters()
    enc = [pvec.encrypt_vector(k.pub, q, rng=np.random.default_rng(3),
                               device=CPU)
           for k, q in zip((big, small), queries)]
    assert pvec.counters == {"vectorized": 1, "object": 1}
    assert enc[0] == jpai.encrypt_vector(_jkey(big).pub, queries[0],
                                         rng=np.random.default_rng(3))
    cts = pvec.encrypted_scores_batch(
        [big.pub, small.pub], enc, cands,
        rngs=[np.random.default_rng(11), np.random.default_rng(12)],
        device=CPU)
    assert pvec.counters == {"vectorized": 2, "object": 2}
    for k, e, c, ct, seed in zip((big, small), enc, cands, cts, (11, 12)):
        assert ct == jpai.encrypted_scores(_jkey(k).pub, e, c,
                                           rng=np.random.default_rng(seed))
    got = pvec.decrypt_scores_batch([big, small], cts, device=CPU)
    assert pvec.counters == {"vectorized": 3, "object": 3}
    for k, ct, g in zip((big, small), cts, got):
        np.testing.assert_array_equal(g, jpai.decrypt_scores(_jkey(k), ct))


def test_counters_hold_under_threads():
    """The router scores batches from several threads: no lost count."""
    big = pai.keygen(1024, rng=np.random.default_rng(0))
    e = np.array([0.25])
    pvec.reset_counters()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            pvec.encrypt_vector(big.pub, e, device=CPU) for _ in range(10)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert pvec.counters == {"vectorized": 0, "object": 80}


def test_device_defaults_to_cuda(monkeypatch):
    """Without a GPU and without an explicit device, the vectorized path
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sk = _keys(1)[0]
    with pytest.raises(RuntimeError):
        pvec.encrypt_vector(sk.pub, np.ones(4) / 2)
    with pytest.raises(RuntimeError):
        pvec.decrypt_scores_batch([sk], [[1, 2]])


# -- backend seam, protocol, keys --------------------------------------------


def test_backend_registry_and_dispatch():
    assert backends.available() == ("paillier", "rlwe")
    assert backends.get_backend("paillier").name == "paillier"
    assert backends.scores_backend([1, 2, 3]).name == "paillier"
    batch = backends.PaillierScoreBatch(cts=[[1], [2]])
    assert batch.lanes() == [[1], [2]]
    with pytest.raises(backends.UnknownBackend) as ei:
        backends.get_backend("ecc")
    assert ei.value.known == ("paillier", "rlwe")


def test_round_through_protocol_on_cpu():
    """run_remoterag with backend="paillier": the plaintext top-k, wire
    bytes from the accounting model, and no RLWE cache built."""
    rng = np.random.default_rng(0)
    emb = synth.uniform_corpus(rng, 256, DIM)
    index = convert.flat_index(emb, [f"d{i}".encode() for i in range(256)],
                               device=CPU)
    user = protocol.RemoteRagUser(n=DIM, N=256, k=3, radius=0.05,
                                  backend="paillier", paillier_bits=256,
                                  rng=np.random.default_rng(1), device=CPU)
    assert user.impl is backends.get_backend("paillier")
    assert user._pai_rng is user.rng and user.paillier_bits == 256
    cloud = protocol.RemoteRagCloud(index)
    q = synth.queries_near_corpus(np.random.default_rng(2), emb, 1)[0]
    docs, ids, tr = protocol.run_remoterag(user, cloud, q,
                                           torch.Generator().manual_seed(0))
    assert cloud._paillier_pub == user.sk.pub
    assert len(docs) == 3 and ids.shape == (3,)
    oracle = np.argsort(-(emb @ q), kind="stable")[:3]
    assert set(ids.tolist()) == set(oracle.tolist())
    kb = user.sk.pub.key_bits
    assert tr.request_bytes == DIM * 4 + 4 + DIM * 2 * kb // 8
    assert tr.reply_bytes == user.plan.kprime * (4 + 2 * kb // 8)
    assert index.peek_candidate_cache(cloud.rlwe_params, None) is None


def test_converted_keys_decrypt_reference_ciphertexts():
    jsk = jpai.keygen(256, rng=np.random.default_rng(21))
    sk = convert.paillier_secret_key(jsk.pub.n, jsk.pub.g, jsk.lam, jsk.mu)
    assert sk.pub == convert.paillier_public_key(jsk.pub.n, jsk.pub.g)
    assert sk.pub.n_sq == jsk.pub.n_sq
    e = _unit(np.random.default_rng(22), DIM)
    enc = jpai.encrypt_vector(jsk.pub, e, rng=np.random.default_rng(23))
    assert pvec.encrypt_vector(sk.pub, e, rng=np.random.default_rng(23),
                               device=CPU) == enc
    cands = _unit(np.random.default_rng(24), 5, DIM)
    cts = jpai.encrypted_scores(jsk.pub, enc, cands)
    np.testing.assert_array_equal(
        pvec.decrypt_scores_batch([sk], [cts], device=CPU)[0],
        jpai.decrypt_scores(jsk, cts))


# -- the reference's vectorized path and round, in a subprocess --------------

ORACLE = r"""
import contextlib, json, os, sys
import jax, jax.experimental
jax.experimental.enable_x64 = contextlib.nullcontext   # this process only
import numpy as np
from repro.core import protocol as jp
from repro.crypto import paillier as pai
from repro.crypto import paillier_vec as pvec
from repro.data import synth
from repro.retrieval.index import FlatIndex

def unit(rng, *shape):
    x = rng.normal(size=shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)

def ints(xs):
    return [hex(int(x)) for x in xs]

out = {}
# (1) vectorized encrypt / score / decrypt, seeded, three lanes
keys = [pai.keygen(256, rng=np.random.default_rng(300 + i)) for i in range(3)]
rng = np.random.default_rng(301)
queries, cands = unit(rng, 3, 32), unit(rng, 3, 9, 32)
enc = [pvec.encrypt_vector(k.pub, q, rng=np.random.default_rng(310 + i))
       for i, (k, q) in enumerate(zip(keys, queries))]
cts = pvec.encrypted_scores_batch(
    [k.pub for k in keys], enc, list(cands),
    rngs=[np.random.default_rng(320 + i) for i in range(3)])
dec = pvec.decrypt_scores_batch(keys, cts)
out["vec"] = dict(queries=queries.tolist(), cands=cands.tolist(),
                  enc=[ints(x) for x in enc], cts=[ints(x) for x in cts],
                  dec=[d.tolist() for d in dec], counters=dict(pvec.counters))
# (2) one run_remoterag(backend="paillier") round
rng = np.random.default_rng(3)
emb = synth.uniform_corpus(rng, 300, 32)
docs = [f"passage-{i}".encode() for i in range(300)]
cloud = jp.RemoteRagCloud(FlatIndex.build(emb, documents=docs))
user = jp.RemoteRagUser(n=32, N=300, k=3, radius=0.05, backend="paillier",
                        paillier_bits=256, rng=np.random.default_rng(7))
e = synth.queries_near_corpus(rng, emb, 1)[0]
seen = {}
handle = cloud.handle_request
def spy(req, **kw):
    seen["req"], seen["rep"] = req, handle(req, **kw)
    return seen["rep"]
cloud.handle_request = spy
got_docs, ids, tr = jp.run_remoterag(user, cloud, e, jax.random.PRNGKey(0))
req, rep = seen["req"], seen["rep"]
out["round"] = dict(
    emb=np.asarray(cloud.index.embeddings).tolist(), e=e.tolist(),
    perturbed=np.asarray(req.perturbed, np.float64).tolist(),
    kprime=int(req.kprime), key=ints([user.sk.pub.n, user.sk.lam, user.sk.mu]),
    enc_query=ints(req.enc_query),
    candidate_ids=np.asarray(rep.candidate_ids).tolist(),
    scores=pai.decrypt_scores(user.sk, rep.enc_scores).tolist(),
    ids=np.asarray(ids).tolist(), docs=[d.decode() for d in got_docs],
    bytes=[tr.request_bytes, tr.reply_bytes, tr.total_bytes])
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("paillier_oracle") / "out.json"
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", ORACLE, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(path.read_text())


def _ints(xs):
    return [int(x, 16) for x in xs]


def test_reference_paillier_vec_in_subprocess_matches_port(oracle):
    v = oracle["vec"]
    assert v["counters"] == {"vectorized": 9, "object": 0}
    keys = [pai.keygen(256, rng=np.random.default_rng(300 + i))
            for i in range(3)]
    queries, cands = np.array(v["queries"]), np.array(v["cands"])
    enc = [pvec.encrypt_vector(k.pub, q, rng=np.random.default_rng(310 + i),
                               device=CPU)
           for i, (k, q) in enumerate(zip(keys, queries))]
    assert enc == [_ints(x) for x in v["enc"]]
    cts = pvec.encrypted_scores_batch(
        [k.pub for k in keys], enc, list(cands),
        rngs=[np.random.default_rng(320 + i) for i in range(3)], device=CPU)
    assert cts == [_ints(x) for x in v["cts"]]
    dec = pvec.decrypt_scores_batch(keys, cts, device=CPU)
    for got, want, c, q in zip(dec, v["dec"], cands, queries):
        np.testing.assert_array_equal(got, np.array(want))
        np.testing.assert_allclose(got, c @ q, atol=2e-3)


def test_reference_round_in_subprocess_matches_port(oracle):
    """The port's round fed the reference's perturbed embedding: the same
    key, query ciphertexts, candidates, decrypted scores, ids, documents
    and wire bytes."""
    r = oracle["round"]
    emb = np.array(r["emb"], np.float32)
    index = convert.flat_index(emb, [f"passage-{i}".encode()
                                     for i in range(len(emb))], device=CPU)
    user = protocol.RemoteRagUser(n=32, N=300, k=3, radius=0.05,
                                  backend="paillier", paillier_bits=256,
                                  rng=np.random.default_rng(7), device=CPU)
    assert [user.sk.pub.n, user.sk.lam, user.sk.mu] == _ints(r["key"])
    cloud = protocol.RemoteRagCloud(index)
    user.impl.prepare_cloud(cloud, user)
    req = protocol.Request(perturbed=torch.tensor(r["perturbed"]),
                           kprime=user.plan.kprime,
                           enc_query=user.encrypt_query(np.array(r["e"])),
                           backend="paillier")
    assert req.kprime == r["kprime"]
    assert req.enc_query == _ints(r["enc_query"])
    rep = cloud.handle_request(req)
    assert rep.candidate_ids.tolist() == r["candidate_ids"]
    scores = user.impl.decrypt_reply(user, rep.enc_scores)
    np.testing.assert_array_equal(scores, np.array(r["scores"]))
    docs, ids, tr = protocol.finish_request(user, cloud, req, rep,
                                            user.top_positions(rep))
    assert ids.tolist() == r["ids"]
    assert [d.decode() for d in docs] == r["docs"]
    assert [tr.request_bytes, tr.reply_bytes, tr.total_bytes] == r["bytes"]
