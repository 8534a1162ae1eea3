"""train_eval_ms: window time per NLML + gradient evaluation completed in
it, the optimizer's time between evaluations included."""

from port_bench import window


def read(run):
    return window.per_item_ms(run.record)
