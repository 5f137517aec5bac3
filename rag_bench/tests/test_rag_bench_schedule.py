"""The traffic generator: schedules reproduce from the seed, and seeds
differ only in order."""

import numpy as np
import pytest

from rag_bench import schedule

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_reproduces_from_the_seed(seed):
    t = {"kind": "poisson", "rate_rps": 37.5}
    a = schedule.make(t, seed=seed, seconds=12, pool=100, tenants=16)
    b = schedule.make(t, seed=seed, seconds=12, pool=100, tenants=16)
    for f in ("arrivals", "query", "tenant", "key"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.size == 450
    assert a.arrivals[0] == 0 and np.all(np.diff(a.arrivals) > 0)
    assert a.arrivals[-1] < 12
    assert set(np.unique(a.tenant)) <= set(range(16))
    assert a.query.max() < 100 and a.key.min() >= 0


def test_poisson_seeds_share_the_gaps_in_another_order():
    t = {"kind": "poisson", "rate_rps": 5.2}
    runs = [schedule.make(t, seed=s, seconds=40, pool=10, tenants=16)
            for s in (1, 2)]
    m = 208
    gaps = -np.log1p(-(np.arange(m) + 0.5) / m) / 5.2
    for s in runs:
        assert s.size == m
        # m arrivals hold m - 1 of the m gaps
        got = np.diff(s.arrivals)
        assert np.isin(np.round(got, 9), np.round(gaps, 9)).all()
    assert not np.array_equal(runs[0].arrivals, runs[1].arrivals)


@pytest.mark.parametrize("seed", SEEDS)
def test_closed_loop_reproduces_from_the_seed(seed):
    t = {"kind": "closed", "clients": 64}
    a = schedule.make(t, seed=seed, seconds=40, pool=8192, tenants=16)
    b = schedule.make(t, seed=seed, seconds=40, pool=8192, tenants=16)
    c = schedule.make(t, seed=seed + 1, seconds=40, pool=8192, tenants=16)
    assert a.clients == 64 and a.arrivals is None
    np.testing.assert_array_equal(a.query, b.query)
    np.testing.assert_array_equal(a.key, b.key)
    assert not np.array_equal(a.key, c.key)


def test_unknown_or_empty_traffic_is_refused():
    with pytest.raises(ValueError):
        schedule.make({"kind": "bursty"}, seed=0, seconds=1, pool=1,
                      tenants=1)
    with pytest.raises(ValueError):
        schedule.make({"kind": "closed", "clients": 0}, seed=0, seconds=1,
                      pool=1, tenants=1)
