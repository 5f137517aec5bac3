"""Distinct routed experts a MoE layer read in a decode step: the mean
over the generator's ``experts_touched`` records left in the tracer's
ring (``metrics_lm.experts_per_layer``)."""

from rag_bench.metrics_lm import experts_per_layer


def read(run):
    return experts_per_layer(run)
