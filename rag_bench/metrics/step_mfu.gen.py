"""Model FLOPs of the generator's prefills and decode steps over their
device time at the H100's dense bfloat16 peak, in percent, over the traced
window: ``lm_counts.prefill_flops`` for each ``prefill_device`` span's
lanes and ``lm_counts.decode_flops`` for each ``decode_device`` span's,
at a decode step's mean context (prompt + half the answer: exact over
whole batches), over the spans' summed seconds."""

from rag_bench import lm_counts
from rag_bench.metrics_lm import decode_context


def read(run):
    t = run.tracer
    if t is None:
        return None
    s = run.shapes
    pre, dec = t.lanes.get("prefill_device", ()), t.lanes.get(
        "decode_device", ())
    seconds = t.seconds.get("prefill_device", 0.0) + t.seconds.get(
        "decode_device", 0.0)
    if seconds <= 0 or not (pre or dec):
        return None
    c, ctx = s["model"], decode_context(run)
    flops = (sum(lm_counts.prefill_flops(c, n, s["prompt_len"]) for n in pre)
             + sum(lm_counts.decode_flops(c, n, ctx) for n in dec))
    return 100.0 * flops / (seconds * lm_counts.BF16_FLOPS_S)
