"""pivchol_ms: device time of the profiler range iterative._pivchol (the
pivoted Cholesky) per evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "iterative._pivchol")
