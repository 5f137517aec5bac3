"""Device milliseconds of a decode step of the generator, over the traced
window: the ``decode_device`` spans (between CUDA events around each
step) over their count."""

from rag_bench.metrics_lm import per_decode_step_ms


def read(run):
    return per_decode_step_ms(run, "decode_device")
