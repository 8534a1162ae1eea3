"""idle_ms.to_host: the card's idle time charged to the profiler range
serve.to_host (the mean and variance's copies to the host),
innermost, per request of the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "serve.to_host")
