"""idle_ms.eval: the card's idle time charged to the profiler range
iterative_fit.value_and_grad (the evaluation outside its stages:
set-up, the warm start's NaN check, the solve's verdict), innermost,
per evaluation of the traced window (port_bench/stages.py)."""

from port_bench import stages


def read(run):
    return stages.idle_ms_per_item(run, "iterative_fit.value_and_grad")
