"""idle_ms.whiten: the card's idle time charged to the profiler range
iterative.precond_sqrt_pieces (eigh of L^T L and the Q build),
innermost, per evaluation of the traced window
(port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative.precond_sqrt_pieces")
