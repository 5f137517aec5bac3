"""Fixed-bucket latency histograms for per-stage duration profiles.

One `StageHistogram` per stage name turns "p99 of the whole pipeline" into
"p99 of each stage".  Buckets are fixed at construction (log2-spaced from
1 µs to ~2 minutes), so recording is O(log #buckets) with zero allocation,
the memory footprint is constant however many samples arrive, and two
histograms from different processes can be merged bucket-by-bucket.

Percentiles are bucket upper-edge estimates: the reported pXX is the
smallest bucket edge whose cumulative count covers XX% of the samples —
an upper bound that is exact to within one bucket (a factor of 2 here).
Exact min/max/total are tracked alongside, so the mean is exact.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence

# Bucket upper edges in seconds: 1us, 2us, 4us, ... 2^27us (~134s).  A
# final implicit overflow bucket catches anything slower.
_EDGES: Sequence[float] = tuple(1e-6 * (1 << i) for i in range(28))


class StageHistogram:
    """Bounded-memory duration histogram with fixed log2 buckets."""

    __slots__ = ("counts", "count", "total_s", "min_s", "max_s")

    def __init__(self) -> None:
        self.counts: List[int] = [0] * (len(_EDGES) + 1)
        self.count = 0
        self.total_s = 0.0
        self.min_s = math.inf
        self.max_s = 0.0

    @staticmethod
    def edges() -> Sequence[float]:
        return _EDGES

    def record(self, duration_s: float) -> None:
        d = max(float(duration_s), 0.0)
        self.counts[bisect.bisect_left(_EDGES, d)] += 1
        self.count += 1
        self.total_s += d
        if d < self.min_s:
            self.min_s = d
        if d > self.max_s:
            self.max_s = d

    def merge(self, other: "StageHistogram") -> None:
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total_s += other.total_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)

    def percentile(self, q: float) -> float:
        """Bucket upper-edge estimate of the q-th percentile (q in 0..100).
        NaN on an empty histogram (never an opaque error)."""
        if not self.count:
            return math.nan
        target = math.ceil(self.count * q / 100.0)
        target = min(max(target, 1), self.count)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                # overflow bucket has no upper edge: report the exact max
                return _EDGES[i] if i < len(_EDGES) else self.max_s
        return self.max_s            # unreachable: counts sum to count

    def summary(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_s": round(self.total_s / self.count, 6),
            "min_s": round(self.min_s, 6),
            "max_s": round(self.max_s, 6),
            "p50_s": round(self.percentile(50), 6),
            "p90_s": round(self.percentile(90), 6),
            "p99_s": round(self.percentile(99), 6),
        }


def summarize(histograms: Dict[str, StageHistogram],
              names: Optional[Sequence[str]] = None) -> dict:
    """{stage: summary} for the given stages (default: all, sorted)."""
    keys = sorted(histograms) if names is None else names
    return {k: histograms[k].summary() for k in keys if k in histograms}


__all__ = ["StageHistogram", "summarize"]
