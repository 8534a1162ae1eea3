"""idle_ms.contraction: the card's idle time charged to the profiler
range iterative._grad_contraction (the gradient's contraction),
innermost, per evaluation of the traced window
(port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative._grad_contraction")
