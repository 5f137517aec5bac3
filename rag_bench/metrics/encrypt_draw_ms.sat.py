"""Host milliseconds in the program's ``encrypt_draw`` spans (a lane's
host draws and host e + Delta*m arithmetic) per completed request, over
the traced window."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "encrypt_draw")
