"""idle_ms.cg: the card's idle time charged to the profiler range
iterative.whitened_solve_info (the CG loop and the warm start's pass,
the whitening's pieces apart), innermost, per evaluation of the
traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative.whitened_solve_info")
