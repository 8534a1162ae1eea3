"""idle_ms.chain_rule: the card's idle time charged to the profiler
range iterative_fit.chain_rule (the surrogate's backward, the
gradient's copy to the host, the reads of the solve's stats),
innermost, per evaluation of the traced window
(port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative_fit.chain_rule")
