"""cg_ms: device time of the profiler range
iterative.whitened_solve_info (the whitened CG solve: K3 at B = 9,
the warm start's pass, the whitening's eigh) per evaluation of the
traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "iterative.whitened_solve_info")
