"""cg_iters.fit: the evaluation closure's last_cg_iters, the mean over
the evaluations completed in the window."""

from port_bench import layer


def read(run):
    return layer.mean_info(run, "cg_iters")
