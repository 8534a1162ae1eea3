"""Idle attribution over program ranges that stages.py does not name.

stages.py charges each idle instant of the card to the innermost
program range open on the host, among the ranges whose names start
with its PREFIXES. The batched L-BFGS's ranges (`batched_lbfgs.`, read
by metrics/idle_ms.lbfgs.py) are not among them, so this module applies
the same rule, with stages.py's own pieces, to its list with them
added. It goes once stages.idle_by_range takes the prefixes as an
argument.
"""

from __future__ import annotations

import bisect

from port_bench import stages

PREFIXES = stages.PREFIXES + ("batched_lbfgs.",)


def idle_by_range(cpu, device):
    """stages.idle_by_range with the program's ranges named by this
    module's PREFIXES: {range name or stages.OUTSIDE: idle seconds}."""
    if not cpu:
        return {}
    lo = min(c[0] for c in cpu)
    hi = max(c[1] for c in cpu)
    ranges = [c for c in cpu if c[2].startswith(PREFIXES)]
    out = {n: 0.0 for _, _, n in ranges}
    out[stages.OUTSIDE] = 0.0
    segs = stages._innermost(ranges, lo, hi)
    starts = [sg[0] for sg in segs]
    for g0, g1 in stages._gaps(device, lo, hi):
        g0, g1 = max(g0, lo), min(g1, hi)
        if g0 >= g1:
            continue
        j = bisect.bisect_right(starts, g0) - 1
        while g0 < g1:
            top = min(g1, segs[j][1])
            out[segs[j][2]] += (top - g0) * 1e-9
            g0, j = top, j + 1
    return out


def idle_ms_per_item(run, prefix: str):
    """Idle charged to the ranges whose names start with `prefix`, per
    answer of the traced window, in ms; None for an untraced run or
    where the window opened no such range (a program that lacks it)."""
    if run.trace is None:
        return None
    if getattr(run, "idle_by_prefix", None) is None:
        events = run.trace._prof.profiler.kineto_results.events()
        run.idle_by_prefix = idle_by_range(*stages.read(events))
    hit = [s for name, s in run.idle_by_prefix.items()
           if name.startswith(prefix)]
    if not hit:
        return None
    return sum(hit) * 1e3 / len(run.record.items)
