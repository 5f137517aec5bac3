"""Host milliseconds in the program's ``decrypt_copy`` spans (d's copy to
the host and its widening to int64) per completed request, over the
traced window."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "decrypt_copy")
