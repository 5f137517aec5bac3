"""Device milliseconds of the MoE layers in a decode step, over the traced
window: the ``moe_device`` spans (gate, dropless grouped experts, shared
experts; layer 0's dense SwiGLU is ``mlp_device`` and not counted) over
the decode steps."""

from rag_bench.metrics_lm import per_decode_step_ms


def read(run):
    return per_decode_step_ms(run, "moe_device")
