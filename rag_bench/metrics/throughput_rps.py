"""Requests completed inside the window over the window's length."""


def read(run):
    return run.completed_by(run.t_end) / run.seconds
