"""predict_pts_per_s: query points whose mean and variance reached the
host, per second of the window."""

from port_bench import window


def read(run):
    return window.points_per_s(run.record)
