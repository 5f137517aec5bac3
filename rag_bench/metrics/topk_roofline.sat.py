"""The first stage's share of its roofline: each batch's least time (the
corpus scanned and the queries in, k' scores and ids out; 2 float32
operations a query, row and coordinate) over the device time of the
operations launched under the ``topk`` spans."""

from rag_bench import counts
from rag_bench.metrics_common import roofline


def read(run):
    s = run.shapes

    def bound(lanes):
        nbytes, ops = counts.topk_counts(lanes, s["rows"], s["dim"],
                                         s["kprime"])
        return counts.bound_s(nbytes, ops, counts.FP32_OPS_S)[0]

    return roofline(run, "topk", bound)
