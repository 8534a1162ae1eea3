"""idle_ms.request: the card's idle time charged to the profiler range
serve.request (the request outside its stages), innermost, per
request of the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "serve.request")
