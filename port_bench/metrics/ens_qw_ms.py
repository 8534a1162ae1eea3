"""ens_qw_ms: device time of the profiler range QuadLogdet.backward
(the QW adjoint: the n-RHS triangular solve and the A^-1 GEMM of every
deposit) per batched evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "QuadLogdet.backward")
