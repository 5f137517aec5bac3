"""Mean lanes per dispatch over the traced window (the ``dispatch`` spans'
batch size, as ``ServeMetrics`` counts it)."""


def read(run):
    lanes = run.tracer.lanes.get("dispatch") if run.tracer else None
    return sum(lanes) / len(lanes) if lanes else None
