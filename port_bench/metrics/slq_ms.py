"""slq_ms: device time of the profiler range
iterative.slq_logdet_batched (SLQ: K3 at B = 32 and the quadrature)
per evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "iterative.slq_logdet_batched")
