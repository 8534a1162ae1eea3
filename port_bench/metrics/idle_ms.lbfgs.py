"""idle_ms.lbfgs: the card's idle time charged to the batched L-BFGS's
profiler ranges (batched_lbfgs.direction, .line_search, .update),
innermost, per batched evaluation of the traced window
(port_bench/stage_idle.py)."""

from port_bench import stage_idle


def read(run):
    return stage_idle.idle_ms_per_item(run, "batched_lbfgs.")
