"""Rates and tails over all requests, the busy union and the idle gaps."""

import math

import pytest

from rag_bench import harness, stats
from rag_bench.metrics_common import roofline


class _Res:
    def __init__(self, ok=True):
        self.ok = ok


def _run(latencies_s, seconds=10.0, fail=()):
    run = harness.Run(seconds=seconds, setup_s=1.0)
    run.t0, run.t_end = 100.0, 100.0 + seconds
    for i, lat in enumerate(latencies_s):
        due = run.t0 + i * seconds / len(latencies_s)
        run.due[i] = due
        run.done[i] = due + lat
        run.result[i] = _Res(ok=i not in fail)
    return run


def test_percentiles_take_every_request():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile(list(range(101)), 95) == 95
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_a_failed_request_misses_every_limit():
    run = _run([0.01] * 99 + [0.02], fail={3})
    lat = run.latencies_ms()
    assert math.isinf(max(lat)) and sum(map(math.isinf, lat)) == 1
    run = _run([0.01] * 20, fail=set(range(5)))
    assert math.isinf(stats.percentile(run.latencies_ms(), 95))


def test_a_stall_in_the_window_moves_rate_and_tail():
    steady = _run([0.05] * 200)
    stalled = _run([0.05] * 170 + [0.05 + 3.0 - 0.1 * j for j in range(30)])
    p95 = [stats.percentile(r.latencies_ms(), 95) for r in (steady,
                                                           stalled)]
    assert p95[1] > 10 * p95[0]
    assert stats.percentile(stalled.latencies_ms(), 50) == \
        stats.percentile(steady.latencies_ms(), 50)
    # the stalled requests finish after the window: the rate counts them out
    assert steady.completed_by(steady.t_end) == 200
    assert stalled.completed_by(stalled.t_end) < 200


def test_union_counts_overlap_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10), (2, 3), (4, 5)]) == 10
    assert stats.union_length([(3, 4), (0, 1), (1, 2)]) == 3
    assert stats.union_length([]) == 0


def test_gaps_are_what_no_interval_covers():
    assert stats.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == \
        [(0, 1), (3, 5), (6, 8)]
    assert stats.gaps([(0, 9)], 0, 8) == []


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([10, 10, 10, 10]) == 0
    # statistics.quantiles' quartiles of 1..5 are 1.5, 3 and 4.5
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(1.0)


def test_a_roofline_of_a_stage_that_ran_nothing_is_left_out():
    class T:
        lanes = {"topk": [8, 8]}
    run = _run([0.01])
    run.tracer = T()
    run.device = {"stage_device_s": {}}
    assert roofline(run, "topk", lambda n: 1e-3) is None
    run.device = {"stage_device_s": {"topk": 4e-3}}
    assert roofline(run, "topk", lambda n: 1e-3) == pytest.approx(50.0)
