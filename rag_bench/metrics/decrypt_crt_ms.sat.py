"""Host milliseconds in the program's ``decrypt_crt`` spans (the host's
launch of the device gather of the extraction coefficients and their
int64 CRT lift) per completed request, over the traced window."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "decrypt_crt")
