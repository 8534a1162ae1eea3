"""ens_active_share: the mean share of the ensemble's members whose
result the batched L-BFGS used in an evaluation (the hook's mask: every
active member at a fit's start, those still searching in a line-search
step), over the evaluations completed in the window, in %. The rest
were evaluated in lock step and discarded."""

from port_bench import layer


def read(run):
    return layer.mean_info(run, "used_pct")
