"""Milliseconds of the program's ``score_device`` spans per completed
request, over the traced window: on the card's stream, from the device
end of the last lane's encryption to the device end of the scoring (the
engine's device marks, mapped onto its clock)."""

from rag_bench.metrics_common import stage_ms_per_request


def read(run):
    return stage_ms_per_request(run, "score_device")
