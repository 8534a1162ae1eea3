"""ens_factor_ms: device time of the profiler range QuadLogdet.forward
(the batched potrf and the alpha solve of every deposit) per batched
evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "QuadLogdet.forward")
