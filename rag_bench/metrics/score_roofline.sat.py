"""The cached encrypted scoring's share of its roofline: each batch's
least time (gathered cache rows and query ciphertexts in, result
ciphertexts out; the NTT and Hadamard integer operations at the int32
rate) over the device time of the operations launched under the
``score`` spans."""

from rag_bench import counts
from rag_bench.metrics_common import roofline


def read(run):
    s, r = run.shapes, run.shapes["rlwe"]

    def bound(lanes):
        nbytes, ops = counts.score_counts(
            lanes, s["kprime"], s["dim"], n_poly=r["n_poly"],
            num_primes=r["num_primes"], chunk=r["chunk"])
        return counts.bound_s(nbytes, ops, counts.INT32_OPS_S)[0]

    return roofline(run, "score", bound)
