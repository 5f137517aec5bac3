"""Host milliseconds in the program's ``topk_certificate`` spans (the
first stage's exactness certificate up to its host bool) per completed
request, over the traced window.  Nothing where k' fits one tile's
candidates (no certificate runs)."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "topk_certificate")
