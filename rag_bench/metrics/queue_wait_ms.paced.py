"""Mean of the engine's ``queue_wait`` spans (enqueue to dispatch) over
the traced window."""


def read(run):
    t = run.tracer
    n = t.count.get("queue_wait", 0) if t is not None else 0
    return 1e3 * t.seconds["queue_wait"] / n if n else None
