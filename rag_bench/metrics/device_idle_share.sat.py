"""Share of the traced window in which no operation ran on the device."""


def read(run):
    d = run.device
    if not d or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
