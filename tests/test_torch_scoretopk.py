"""Port score + top-k modules (repro_torch.kernels.scoretopk, retrieval)
against the JAX package.

Scores agree within 1e-5 relative: both sum float32 products in float32,
in different orders, so the two differ in the last bits.  Ids must be equal, except where the two ids' exact
scores lie within that same 1e-5 of each other (a tie the reference's
rounding broke one way and the port's the other).  Exact ties go to the
lower row id in both."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.scoretopk import ops as jops
from repro.kernels.scoretopk import ref as jref
from repro.kernels.scoretopk import scoretopk as jkern
from repro.retrieval.index import FlatIndex as JFlatIndex
from repro.retrieval.index import plan_row_slices as j_plan_row_slices
from repro.retrieval.topk import distributed_topk as j_distributed_topk
from repro.retrieval.topk import slice_topk as j_slice_topk
from repro_torch import convert
from repro_torch.kernels.scoretopk import ops, ref
from repro_torch.kernels.scoretopk import scoretopk as tkern
from repro_torch.retrieval import index as tindex
from repro_torch.retrieval import topk as ttopk


def assert_ids_equal_up_to_ties(got, want, q, e, rtol=1e-5):
    """got/want: (..., B, k) ids for queries q (B, n) over rows e."""
    got, want = np.asarray(got), np.asarray(want)
    for pos in zip(*np.nonzero(got != want)):
        b = pos[-2]
        s_got = float(e[got[pos]].astype(np.float64) @ q[b])
        s_want = float(e[want[pos]].astype(np.float64) @ q[b])
        assert abs(s_got - s_want) <= rtol * abs(s_want), (pos, s_got, s_want)


def _data(seed, b, n_rows, n):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, n)).astype(np.float32)
    e = rng.normal(size=(n_rows, n)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    return q, e


@pytest.mark.parametrize("b,n_rows,n,kk,tile", [
    (1, 512, 128, 8, 256),
    (4, 1000, 384, 16, 256),     # non-multiple rows -> padding path
    (2, 4096, 768, 32, 2048),
    (8, 300, 64, 300, 512),      # kk > rows in the tile tail
])
def test_tile_topk_matches_pallas(b, n_rows, n, kk, tile):
    q, e = _data(0, b, n_rows, n)
    kk_eff = min(kk, tile, n_rows)
    want_v, want_i = jkern.score_topk_pallas(jnp.asarray(q), jnp.asarray(e),
                                             kk=kk_eff, tile=tile)
    got_v, got_i = ref.tile_topk_ref(torch.from_numpy(q), torch.from_numpy(e),
                                     kk_eff, tile)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v.numpy()), finite)
    np.testing.assert_allclose(got_v.numpy()[finite], want_v[finite],
                               rtol=1e-5, atol=1e-6)
    got_i = got_i.numpy()
    assert_ids_equal_up_to_ties(np.where(finite, got_i, 0),
                                np.where(finite, want_i, 0), q, e)
    assert (got_i[~finite] == n_rows).all()


@pytest.mark.parametrize("per_tile_k", [None, 32])
def test_topk_scores_matches_reference(per_tile_k):
    q, e = _data(2, 3, 5000, 256)
    want = jops.topk_scores(jnp.asarray(q), jnp.asarray(e), k=25, tile=1024,
                            per_tile_k=per_tile_k, use_pallas=True)
    got = ops.topk_scores(torch.from_numpy(q), torch.from_numpy(e), 25,
                          tile=1024, per_tile_k=per_tile_k)
    assert got.exact == bool(want.exact)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-6)
    assert_ids_equal_up_to_ties(got.indices, want.indices, q, e)


def test_ties_break_toward_lower_id():
    q, e = _data(3, 2, 700, 32)
    # copies of each query's best row: exact ties within one tile and
    # across tiles, all inside the top 40
    for b, dups in ((0, (650, 300, 1)), (1, (5, 699))):
        best = int(np.argmax(e @ q[b]))
        for d in dups:
            e[d] = e[best]
    for tile in (256, 700):
        got = ops.topk_scores(torch.from_numpy(q), torch.from_numpy(e), 40,
                              tile=tile)
        want = jops.topk_scores(jnp.asarray(q), jnp.asarray(e), k=40,
                                tile=tile, use_pallas=True)
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(want.indices))
        v, i = got.values.numpy(), got.indices.numpy()
        assert (np.diff(v, axis=1) == 0).sum() >= 3     # the ties are there
        for row in range(2):
            order = np.lexsort((i[row], -v[row]))
            np.testing.assert_array_equal(order, np.arange(40))


def test_k_exceeds_corpus():
    q, e = _data(6, 1, 17, 16)
    got = ops.topk_scores(torch.from_numpy(q), torch.from_numpy(e), 40)
    want = jops.topk_scores(jnp.asarray(q), jnp.asarray(e), k=40,
                            use_pallas=True)
    assert tuple(got.indices.shape) == (1, 17)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_certificate_detects_adversarial_tile():
    """All winners in one tile with kk < k: the certificate must say so,
    and the exact fallback recovers the reference's answer."""
    n, k = 64, 16
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, n)).astype(np.float32)
    base = rng.normal(size=(2048, n)).astype(np.float32) * 0.01
    base[:32] = q[0] * 10.0
    got = ops.topk_scores(torch.from_numpy(q), torch.from_numpy(base), k,
                          tile=256, per_tile_k=8)
    want = jops.topk_scores(jnp.asarray(q), jnp.asarray(base), k=k, tile=256,
                            per_tile_k=8, use_pallas=True)
    assert got.exact is False and not bool(want.exact)
    fb = ops.exact_fallback(torch.from_numpy(q), torch.from_numpy(base), k)
    want_v, want_i = jref.topk_ref(jnp.asarray(q), jnp.asarray(base), k)
    np.testing.assert_allclose(fb.values.numpy(), np.asarray(want_v), rtol=1e-5)
    np.testing.assert_array_equal(fb.indices.numpy(), np.asarray(want_i))


def _certificate_case(case):
    """(q, e, k, tile, per_tile_k, want) for one certificate case; ``want``
    is the known answer (None where the data decide it)."""
    if case == "padded":            # last tile 232 rows, the kk-th place
        q, e = _data(10, 3, 1000, 32)
        return q, e, 40, 256, 24, None
    if case == "kk_eq_tile":        # k' > tile, so kk = tile (the tower's)
        q, e = _data(11, 2, 20_000, 32)
        return q, e, 700, 256, None, True
    if case == "kk_lt_tile":
        q, e = _data(12, 4, 5000, 64)
        return q, e, 100, 512, 16, None
    if case == "clustered":         # every winner in tile 1
        q, e = _data(13, 1, 2048, 64)
        e[300:340] = q[0] * 10.0
        return q, e, 16, 256, 8, False
    if case == "sentinel":          # rows past tile 0 score -inf: the merged
        q, e = _data(14, 2, 1500, 16)   # ids hold N from every other tile
        q = np.abs(q) + 1e-3
        e[256:] = -np.inf
        return q, e, 400, 256, 100, False
    if case == "one_lane_clustered":  # lane 2's winners all in tile 1
        q, e = _data(15, 4, 4096, 64)
        e[600:700] = q[2] * 10.0
        return q, e, 64, 512, 32, False
    raise ValueError(case)


@pytest.mark.parametrize("case", ["padded", "kk_eq_tile", "kk_lt_tile",
                                  "clustered", "sentinel",
                                  "one_lane_clustered"])
def test_certificate_matches_reference(case):
    """The per-tile count gives the reference's membership answer."""
    q, e, k, tile, ptk, want = _certificate_case(case)
    got = ops.topk_scores(torch.from_numpy(q), torch.from_numpy(e), k,
                          tile=tile, per_tile_k=ptk)
    ref_ = jops.topk_scores(jnp.asarray(q), jnp.asarray(e), k=k, tile=tile,
                            per_tile_k=ptk, use_pallas=True)
    assert got.exact == bool(ref_.exact)
    if want is not None:
        assert got.exact is want
    if case == "sentinel":
        assert bool((got.indices == e.shape[0]).any())


def _membership_certificate(tile_idx, merged_idx, kk):
    """The certificate as a membership broadcast, O(B·N·k')."""
    cand = tile_idx.transpose(0, 1)                      # (B, T, kk)
    member = (cand[..., None] == merged_idx[:, None, None, :]).any(-1)
    return bool(torch.all(member.sum(-1) < kk))


@pytest.mark.parametrize("seed", range(6))
def test_certificate_equals_membership_broadcast(seed):
    """Random shapes, padded tiles, clustered lanes and -inf rows: the
    per-tile count equals the membership broadcast on every case."""
    rng = np.random.default_rng(300 + seed)
    answers = set()
    for _ in range(25):
        b, n_rows = int(rng.integers(1, 5)), int(rng.integers(40, 2500))
        tile = int(rng.choice([32, 64, 128, 256]))
        q, e = _data(int(rng.integers(1 << 30)), b, n_rows, 8)
        t = min(tile, n_rows)
        k = int(rng.integers(2, min(n_rows, 600) + 1))
        kk = int(rng.integers(1, min(k - 1, t) + 1))
        if rng.random() < 0.4:                          # one lane clustered
            lo = int(rng.integers(0, n_rows))
            e[lo:lo + kk + 3] = q[int(rng.integers(b))] * 10.0
        if rng.random() < 0.3:                          # -inf rows
            q = np.abs(q) + 1e-3
            e[rng.random(n_rows) < rng.random()] = -np.inf
        vals, gidx = ref.tile_topk_ref(torch.from_numpy(q),
                                       torch.from_numpy(e), kk, t)
        _, mi = ref.merge_tiles_ref(vals, gidx, k)
        got = ops._certificate(gidx, mi, kk, t, n_rows)
        assert got == _membership_certificate(gidx, mi, kk), (b, n_rows, t,
                                                               k, kk)
        answers.add(got)
    assert answers == {True, False}


def test_distributed_and_slice_topk_match_reference():
    q, e = _data(7, 4, 3000, 96)
    jidx = JFlatIndex.build(e)
    tidx = convert.flat_index(np.asarray(jidx.embeddings), device="cpu")
    got = ttopk.distributed_topk(tidx, torch.from_numpy(q), 20, tile=512)
    want = j_distributed_topk(jidx, jnp.asarray(q), 20, tile=512,
                              use_pallas=False)
    assert got.exact and bool(want.exact)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(ttopk.distances_from_scores(got.values).numpy(),
                               1.0 - np.asarray(want.values), atol=1e-5)
    # two slices merged by (score desc, id asc) reproduce the full scan
    parts = [ttopk.slice_topk(tidx.slice_view(a, b), torch.from_numpy(q), 20,
                              tile=512) for a, b in ((0, 1700), (1700, 3000))]
    for part, (a, b) in zip(parts, ((0, 1700), (1700, 3000))):
        jpart = j_slice_topk(jidx.slice_view(a, b), jnp.asarray(q), 20,
                             tile=512, use_pallas=False)
        np.testing.assert_array_equal(part.indices.numpy(),
                                      np.asarray(jpart.indices))
    v = torch.cat([p.values for p in parts], 1).numpy()
    i = torch.cat([p.indices for p in parts], 1).numpy()
    for row in range(4):
        order = np.lexsort((i[row], -v[row]))[:20]
        np.testing.assert_array_equal(i[row][order], got.indices.numpy()[row])


@pytest.mark.parametrize("rows,slices,align", [(3000, 2, 1), (1000, 3, 64),
                                               (10, 10, 1), (100, 4, 16)])
def test_plan_row_slices_and_views_match_reference(rows, slices, align):
    ranges = tindex.plan_row_slices(rows, slices, align=align)
    assert ranges == j_plan_row_slices(rows, slices, align=align)
    q, e = _data(9, 2, rows, 16)
    tidx = tindex.FlatIndex.build(e, device="cpu")
    view = tidx.corpus_view()
    assert view.epoch == tidx.epoch == 0 and view.cluster_map is None
    for a, b in ranges:
        sl = view.slice_view(a, b)
        assert (sl.start, sl.stop, sl.num_rows) == (a, b, b - a)
        assert torch.equal(sl.embeddings, tidx.slice_view(a, b).embeddings)
    with pytest.raises(ValueError, match="out of range"):
        tidx.slice_view(0, rows + 1)
    with pytest.raises(ValueError, match="epoch"):
        tidx.corpus_view(1)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, e = _data(8, 1, 10, 8)
    with pytest.raises(ValueError):
        tkern.score_topk_cuda(torch.from_numpy(q), torch.from_numpy(e), kk=2)
