"""Host milliseconds in the program's ``decrypt_copy`` spans (the copy of
the (B, k') float64 scores to the host) per completed request, over the
traced window."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "decrypt_copy")
