"""kB (10^3 bytes) of scores copied to the host per lane: the mean, over
the program's ``decrypt_copy`` spans left in the tracer's ring, of their
``bytes`` over their ``lanes``: the batch's widest k' times 8, its
float64 scores."""


def read(run):
    t = run.tracer
    if t is None:
        return None
    per_lane = [s.attrs["bytes"] / s.attrs["lanes"] for s in t.spans()
                if s.name == "decrypt_copy"]
    if not per_lane:
        return None
    return sum(per_lane) / len(per_lane) / 1e3
