"""idle_ms.to_device: the card's idle time charged to the profiler range
serve.to_device (the query's upload), innermost, per request of the
traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "serve.to_device")
