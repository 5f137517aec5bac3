"""Device milliseconds of the generator's prefills per prompt prefilled,
over the traced window: the ``prefill_device`` spans (between CUDA
events around each prefill, on the tracer's clock) over their lanes."""


def read(run):
    t = run.tracer
    lanes = sum(t.lanes.get("prefill_device", ())) if t is not None else 0
    if not lanes:
        return None
    return 1e3 * t.seconds["prefill_device"] / lanes
