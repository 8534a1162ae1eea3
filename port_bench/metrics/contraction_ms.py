"""contraction_ms: device time of the profiler range
iterative._grad_contraction (the gradient's contraction against dA)
per evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "iterative._grad_contraction")
