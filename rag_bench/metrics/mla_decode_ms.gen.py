"""Device milliseconds of latent attention in a decode step, over the
traced window: the ``mla_device`` spans of every layer (from the end of
the layer's input to the end of its absorbed attention and output
projection; layer 0's also holds the embedding's gather) over the decode
steps."""

from rag_bench.metrics_lm import per_decode_step_ms


def read(run):
    return per_decode_step_ms(run, "mla_device")
