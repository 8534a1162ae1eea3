"""ens_gram_bwd_ms: device time of the profiler range
FusedExpansBiasA.backward (K1's training backward on the batched Gram
tiles) per batched evaluation of the traced window."""

from port_bench import layer


def read(run):
    return layer.range_ms_per_item(run, "FusedExpansBiasA.backward")
