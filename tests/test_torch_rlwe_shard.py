"""The port's sharded candidate cache against its dense cache, its cold
path and the JAX package's `ShardedCandidateCache`.

Both caches read the same packed pool (the reference's, carried over by
`repro_torch.convert`); scores must match bit for bit whatever the
resident set, and the synchronous LRU trace of the reference suite must
give the same hits, misses, evictions and resident shards at every step.
The async admitter, stream-only and fixed-placement modes are held to the
reference's semantics on the CPU (plain path)."""

import threading

import numpy as np
import pytest
import torch

from repro.crypto import rlwe as jr
from repro_torch import convert
from repro_torch.crypto import rlwe as tr
from repro_torch.retrieval.index import FlatIndex

JP = jr.RlweParams(n_poly=1024, chunk=512)
TP = tr.RlweParams(n_poly=1024, chunk=512)
NUM_DOCS = 40
KPRIME = 9          # not a multiple of cands_per_ct=2: pad path
SHARD_DOCS = 8      # 5 shards over 40 docs
# the reference suite's LRU trace (gathers visit shards in sorted order)
TRACE = [np.array([[0, 1, 8, 9]]), np.array([[16, 17, 0, 1]]),
         np.array([[8, 9, 8, 9]]), np.array([[32, 33, 39, 0]])]


def _unit(rng, *shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=[384, 768])
def world(request):
    """n_dim 384 <= chunk (2 cands/ct) and 768 > chunk (1 cand/ct, 2
    chunks): both packing regimes."""
    n_dim = request.param
    rng = np.random.default_rng(n_dim)
    docs = _unit(rng, NUM_DOCS, n_dim)
    queries = _unit(rng, 8, n_dim)
    jdense = jr.build_candidate_cache(JP, docs)
    jsk = jr.keygen(JP, np.random.default_rng(0))
    tsk = tr.keygen(TP, np.random.default_rng(0), device="cpu")
    enc_rng = np.random.default_rng(1)
    jq = [jr.encrypt_query(jsk, q, enc_rng) for q in queries]
    enc_rng = np.random.default_rng(1)
    tq = [tr.encrypt_query(tsk, q, enc_rng) for q in queries]
    dense = tr.build_candidate_cache(TP, torch.from_numpy(docs))
    np.testing.assert_array_equal(dense.polys.numpy(),
                                  np.asarray(jdense.polys))
    return dict(n_dim=n_dim, docs=docs, jdense=jdense, dense=dense, jq=jq,
                tq=tq)


def _sharded(dense, **kw):
    kw.setdefault("shard_docs", SHARD_DOCS)
    return tr.shard_candidate_cache(dense, tr.CandidateCacheConfig(**kw))


def _jsharded(jdense, **kw):
    kw.setdefault("shard_docs", SHARD_DOCS)
    return jr.shard_candidate_cache(jdense, jr.CandidateCacheConfig(**kw))


def _converted(w, **kw):
    """The port's cache over the reference's host pool, same knobs."""
    kw.setdefault("shard_docs", SHARD_DOCS)
    j = w["jdense"]
    return convert.sharded_candidate_cache(
        TP, j.host_pool(), np.asarray(j.twiddles), w["n_dim"],
        tr.CandidateCacheConfig(**kw), device="cpu")


def _equal(a, b):
    for x, y in ((a.c0, b.c0), (a.c1, b.c1)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_shard_geometry_and_pool(world):
    dense = world["dense"]
    sh = _sharded(dense)
    assert sh.num_shards == 5 and sh.shard_docs == SHARD_DOCS
    assert (sh.stride, sh.cands_per_ct, sh.num_chunks) == (
        dense.stride, dense.cands_per_ct, dense.num_chunks)
    assert sh.pool_nbytes == dense.nbytes
    assert sh.pool is dense.host_pool()         # one host array, re-viewed
    assert sh.shard_of(0) == 0 and sh.shard_of(NUM_DOCS - 1) == 4
    assert sh.resident_bytes == 0 and sh.resident_shards == ()
    built = tr.build_sharded_candidate_cache(
        TP, torch.from_numpy(world["docs"]),
        config=tr.CandidateCacheConfig(num_shards=4))
    np.testing.assert_array_equal(built.pool, dense.host_pool())
    assert built.num_shards == 4
    assert torch.equal(built.twiddles, dense.twiddles)


@pytest.mark.parametrize("bsz", [1, 3, 8])
def test_sharded_equals_dense_cold_and_reference(world, bsz):
    """sharded == dense == cold in the port, and == the reference's
    sharded cache over the same pool."""
    rng = np.random.default_rng(bsz)
    ids = rng.integers(0, NUM_DOCS, size=(bsz, KPRIME))
    tq, jq, n_dim = world["tq"][:bsz], world["jq"][:bsz], world["n_dim"]
    dense = world["dense"]
    cold = tr.encrypted_scores_batch_stacked(
        TP, tq, tr.pack_candidates_batch(TP, world["docs"][ids],
                                         device="cpu"), KPRIME, n_dim)
    cached = tr.encrypted_scores_cached_batch(TP, tq, dense, ids)
    sh = _sharded(dense, max_resident_bytes=2 * dense.nbytes // 5)
    got = tr.encrypted_scores_cached_batch(TP, tq, sh, ids)
    conv = tr.encrypted_scores_cached_batch(TP, tq, _converted(world), ids)
    for other in (cached, got, conv):
        _equal(cold, other)
        assert (other.n_dim, other.num_cands) == (n_dim, KPRIME)
    if bsz == 8:        # one reference compile per packing regime
        _equal(jr.encrypted_scores_cached_batch(
            JP, jq, _jsharded(world["jdense"]), ids, use_pallas=False), got)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_lru_trace_matches_reference(world, mode):
    """The reference's fixed LRU trace on both caches: the synchronous
    first-touch mode step by step, and the async admitter (threshold 1)
    after a flush at every step — same hits, misses, evictions and
    resident set (LRU -> MRU) as the reference, and the dense cache's bits
    at every step."""
    dense = world["dense"]
    budget = 2 * dense.nbytes // 5              # room for 2 of 5 shards
    kw = (dict(async_admission=False) if mode == "sync"
          else dict(admit_threshold=1))
    sh = _converted(world, max_resident_bytes=budget, **kw)
    ref = _jsharded(world["jdense"], max_resident_bytes=budget, **kw)
    for ids in TRACE:
        got = tr.encrypted_scores_cached_batch(TP, world["tq"][:1], sh, ids)
        _equal(tr.encrypted_scores_cached_batch(TP, world["tq"][:1], dense,
                                                ids), got)
        ref.gather(ids)
        sh.flush()
        ref.flush()
        assert (sh.hits, sh.misses, sh.evictions, sh.resident_shards) == (
            ref.hits, ref.misses, ref.evictions, ref.resident_shards)
        assert sh.resident_bytes <= budget
    assert (sh.hits, sh.misses, sh.evictions) == (1, 6, 4)
    assert sh.resident_shards == (0, 4)
    assert sh.admissions == ref.admissions
    assert sh.async_admissions == ref.async_admissions
    ref.close()
    sh.close()


def test_stream_only_and_fixed_placement(world):
    dense, tq = world["dense"], world["tq"][:1]
    ids = np.arange(KPRIME)[None] % NUM_DOCS
    want = tr.encrypted_scores_cached_batch(TP, tq, dense, ids)
    sh = _sharded(dense, max_resident_bytes=0)
    _equal(want, tr.encrypted_scores_cached_batch(TP, tq, sh, ids))
    assert sh.prefetch(ids) == 2 and sh.prefetch(ids) == 2
    sh.flush()
    assert sh.resident_shards == () and sh.evictions == 0
    assert sh.misses > 0 and sh.gathered_bytes > 0
    assert sh.stats()["prefetches"] == 4 and sh.admissions == 0
    # a shard bigger than the whole budget is never pinned either
    tight = _sharded(dense, max_resident_bytes=dense.nbytes // 5 - 1)
    tr.encrypted_scores_cached_batch(TP, tq, tight, ids)
    assert tight.resident_shards == ()
    # operator placement: pin_on_access=False keeps the resident set fixed
    fixed = _sharded(dense, pin_on_access=False)
    fixed.pin(2)
    ids = np.array([[0, 8, 16, 17]])           # shards 0, 1 miss; 2 hits
    _equal(tr.encrypted_scores_cached_batch(TP, tq, dense, ids),
           tr.encrypted_scores_cached_batch(TP, tq, fixed, ids))
    assert fixed.resident_shards == (2,)
    assert (fixed.hits, fixed.misses) == (1, 2)


def test_gather_bit_identical_while_admission_in_flight(world):
    """The gather streams from the host pool while the admitter's copy is
    held mid-flight, and hits the resident shards after the swap: the
    scores are the dense cache's before, during and after."""
    dense, tq = world["dense"], world["tq"][:1]
    sh = _sharded(dense, admit_threshold=1)
    started, release = threading.Event(), threading.Event()

    def hook(_s):
        started.set()
        assert release.wait(30)
    sh._admit_hook = hook
    ids = np.array([[0, 1, 2, 3, 8, 9]])       # shards 0 and 1
    want = tr.encrypted_scores_cached_batch(TP, tq, dense, ids)
    first = tr.encrypted_scores_cached_batch(TP, tq, sh, ids)  # enqueues 0, 1
    assert started.wait(30)
    assert sh.stats()["pending_admissions"] > 0
    inflight = tr.encrypted_scores_cached_batch(TP, tq, sh, ids)
    release.set()
    sh.flush()
    assert sh.resident_shards == (0, 1) and sh.async_admissions == 2
    resident = tr.encrypted_scores_cached_batch(TP, tq, sh, ids)
    for got in (first, inflight, resident):
        _equal(want, got)
    assert sh.hits >= 2
    assert sh._worker is None                   # flush joined the admitter


def test_admission_policy_matches_reference(world):
    """Second-touch admission, counter decay and the prefetch touch credit
    give the reference's counters on the same gather/prefetch sequence."""
    keys = ("hits", "misses", "admissions", "async_admissions",
            "prefetches", "admit_enqueued", "admit_dropped",
            "policy_deferrals", "resident_shards")

    def run(make):
        out = []
        for kw, steps in (
                ({}, [("g", [[0, 1]]), ("g", [[8, 9]]), ("g", [[0, 1]]),
                      ("g", [[16]]), ("g", [[0]])]),
                (dict(admit_window=4), [("g", [[0]]), ("g", [[8]]),
                                        ("g", [[16]]), ("g", [[24]]),
                                        ("g", [[0]])]),
                ({}, [("p", [[0, 1, 8]]), ("g", [[0, 1, 8]]),
                      ("p", [[0, 1, 8]]), ("g", [[0, 1, 8]])])):
            c = make(**kw)
            for op, ids in steps:
                (c.prefetch if op == "p" else c.gather)(np.array(ids))
                c.flush()
                st = c.stats()
                out.append(tuple(st[k] for k in keys))
            c.close()
        return out

    assert run(lambda **kw: _converted(world, **kw)) == run(
        lambda **kw: _jsharded(world["jdense"], **kw))


def test_admit_queue_bounded_drops_are_counted(world):
    sh = _sharded(world["dense"], admit_threshold=1, max_pending_admissions=1)
    started, release = threading.Event(), threading.Event()

    def hook(_s):
        started.set()
        assert release.wait(30)
    sh._admit_hook = hook
    sh.gather(np.array([[0, 8, 16, 24, 32]]))  # 5 shards, queue cap 1
    assert started.wait(30)
    assert sh.stats()["admit_dropped"] >= 2
    release.set()
    sh.flush()
    assert len(sh.resident_shards) <= 2
    for _ in range(4):                         # dropped shards stay eligible
        sh.gather(np.array([[0, 8, 16, 24, 32]]))
        sh.flush()
    assert len(sh.resident_shards) == 5
    sh.close()
    sh.close()                                 # idempotent
    assert sh.stats()["pending_admissions"] == 0


def test_failed_admission_is_counted_not_stranded(world):
    """An admitter copy that raises is dropped, counted and traced by its
    class name; flush does not hang and the shard stays eligible."""
    from repro_torch import obs

    sh = _sharded(world["dense"], admit_threshold=1)
    tracer = obs.Tracer()
    sh.set_trace_context(tracer, 0)

    def hook(_s):
        raise OSError("copy failed")
    sh._admit_hook = hook
    sh.gather(np.array([[0]]))
    sh.flush()
    assert sh.resident_shards == () and sh.stats()["admit_failures"] == 1
    admit = [x for x in tracer.spans() if x.name == "cache_admit"]
    assert [x.attrs["error_type"] for x in admit] == ["OSError"]
    sh._admit_hook = None
    sh.gather(np.array([[0]]))
    sh.flush()
    assert sh.resident_shards == (0,) and sh.async_admissions == 1


def test_gather_rows_and_ids(world):
    dense = world["dense"]
    sh = _sharded(dense)
    ids = np.random.default_rng(3).integers(0, NUM_DOCS, size=(2, 5))
    np.testing.assert_array_equal(sh.gather(ids).numpy(),
                                  dense.polys.numpy()[ids])
    for bad in ([[0, -1]], [[NUM_DOCS]]):
        with pytest.raises(IndexError, match="candidate ids"):
            sh.gather(np.array(bad))
        with pytest.raises(IndexError, match="candidate ids"):
            sh.prefetch(np.array(bad))
    assert sh.prefetch(np.empty((1, 0), np.int64)) == 0
    other = tr.RlweParams(n_poly=1024, chunk=256)
    with pytest.raises(ValueError, match="rebuild the cache"):
        sh.check_compatible(other)
    with pytest.raises(ValueError, match="n_dim"):
        sh.check_compatible(TP, n_dim=world["n_dim"] + 64)


def test_densify_and_index_memoization(world):
    dense, tq = world["dense"], world["tq"][:1]
    sh = _sharded(dense)
    back = tr.densify_candidate_cache(sh)
    assert torch.equal(back.polys, dense.polys)
    assert tr.shard_candidate_cache(
        sh, tr.CandidateCacheConfig(shard_docs=4)).pool is sh.pool
    ids = np.arange(KPRIME)[None] % NUM_DOCS
    _equal(tr.encrypted_scores_cached_batch(TP, tq, back, ids),
           tr.encrypted_scores_cached_batch(TP, tq, sh, ids))
    index = FlatIndex.build(world["docs"], normalize=False, device="cpu")
    cfg = tr.CandidateCacheConfig(shard_docs=SHARD_DOCS)
    a = index.candidate_cache(TP, cfg)
    assert isinstance(a, tr.ShardedCandidateCache)
    assert index.candidate_cache(
        tr.RlweParams(n_poly=1024, chunk=512),
        tr.CandidateCacheConfig(shard_docs=SHARD_DOCS)) is a
    d = index.candidate_cache(TP)
    assert isinstance(d, tr.CandidateCache) and d.host_pool() is a.pool
    assert index.peek_candidate_cache(TP, cfg) is a
    assert index.peek_candidate_cache(
        TP, tr.CandidateCacheConfig(shard_docs=5)) is None
    assert index.candidate_cache(
        TP, tr.CandidateCacheConfig(shard_docs=4)).pool is a.pool


def test_config_validation():
    with pytest.raises(ValueError, match="shard_docs must be positive"):
        tr.CandidateCacheConfig(shard_docs=0).resolve_shard_docs(10)
    with pytest.raises(ValueError, match="num_shards must be positive"):
        tr.CandidateCacheConfig(num_shards=0).resolve_shard_docs(10)
    for knob in ("admit_threshold", "admit_window", "max_pending_admissions"):
        with pytest.raises(ValueError, match=knob):
            tr.CandidateCacheConfig(**{knob: 0})
    cfg = tr.CandidateCacheConfig()
    assert cfg.resolve_admit_window(5) == 8 and cfg.resolve_admit_window(16) == 16
    assert cfg.resolve_shard_docs(40) == 5
