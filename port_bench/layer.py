"""Small helpers the per-layer readers share."""

from __future__ import annotations


def range_ms_per_item(run, name: str):
    """Device time of a profiler range per answer the traced window ran
    (the last may have ended after the planned close), in ms."""
    if run.trace is None or name not in run.trace.ranges:
        return None
    return run.trace.ranges[name] * 1e3 / len(run.record.items)


def mean_info(run, key: str):
    vals = [it.info[key] for it in run.record.completed()
            if key in it.info]
    return sum(vals) / len(vals) if vals else None


def idle_pct(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
