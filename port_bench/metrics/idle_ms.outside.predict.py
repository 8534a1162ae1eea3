"""idle_ms.outside.predict: the card's idle time with no program range
open on the host (the client loop between requests), per request of
the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, stages.OUTSIDE)
