"""idle_ms.outside.fit: the card's idle time with no program range open
on the host (the replay loop between evaluations), per evaluation of
the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, stages.OUTSIDE)
