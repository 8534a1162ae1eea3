"""idle_ms.slq: the card's idle time charged to the profiler range
iterative.slq_logdet_batched (the Lanczos steps and the quadrature),
innermost, per evaluation of the traced window
(port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative.slq_logdet_batched")
