"""Host milliseconds in the engine's ``encrypt`` spans per completed
request, over the traced window."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "encrypt")
