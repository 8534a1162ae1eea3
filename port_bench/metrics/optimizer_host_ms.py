"""optimizer_host_ms: the window's time outside the evaluations per
evaluation completed in it, in ms: from the window's start to the end of
its last completed evaluation, less the evaluations' own spans (as
`fit(timing=)` records them, each ending in the host read of its value
and gradient). What is left is the host optimizer's work between
evaluations (direction, projection, line-search bookkeeping, the
callback) and the restart of each fit."""

from port_bench import window


def read(run):
    done = run.record.completed()
    if not done:
        return None
    inside = sum(it.t_done - it.t_send for it in done)
    return (window.span_s(run.record) - inside) * 1e3 / len(done)
