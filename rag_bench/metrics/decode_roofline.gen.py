"""The decode step's share of its roofline, in percent, over the traced
window: each ``decode_device`` span's least bytes
(``lm_counts.decode_bytes`` at its lanes, a step's mean context and the
mean experts a MoE layer touched, ``experts_touched.gen``) at the HBM
rate, over the spans' summed seconds.  Byte-bound: a step's FLOPs at the
bfloat16 peak take under a tenth of its bytes' time."""

from rag_bench import counts, lm_counts
from rag_bench.metrics_lm import decode_context, experts_per_layer


def read(run):
    t = run.tracer
    if t is None:
        return None
    dec = t.lanes.get("decode_device", ())
    seconds = t.seconds.get("decode_device", 0.0)
    touched = experts_per_layer(run)
    if not dec or seconds <= 0 or touched is None:
        return None
    c, ctx = run.shapes["model"], decode_context(run)
    least = sum(lm_counts.decode_bytes(c, n, ctx, touched) for n in dec)
    return 100.0 * least / counts.HBM_BYTES_S / seconds
