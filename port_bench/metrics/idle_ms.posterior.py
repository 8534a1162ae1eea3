"""idle_ms.posterior: the card's idle time charged to the profiler range
serve.posterior (the posterior's launches), innermost, per request of
the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "serve.posterior")
