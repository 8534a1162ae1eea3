"""device_idle.train: the share of the traced window in which no kernel
ran on the card (1 - union of kernel intervals / window)."""

from port_bench import layer


def read(run):
    return layer.idle_pct(run)
