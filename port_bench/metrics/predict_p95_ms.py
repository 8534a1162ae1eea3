"""predict_p95_ms: 95th percentile of the latency of every request
completed in the window, each timed from its send (one client, closed
loop)."""

from port_bench import window


def read(run):
    return window.p95_ms(run.record)
