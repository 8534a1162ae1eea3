"""Reading the card's trace of a measured window (torch.profiler).

`Traced` profiles the window (CPU ops and CUDA activity) and reduces it
to what the per-layer metrics read: the kernels (name, start, duration),
their union (`busy_s`) against the traced window's length (`window_s`),
the device time of every profiler range (the kernels that start inside
its device-side span), and the breakdown a result line carries.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

class Traced:
    """Context manager: profile the block, then summarize it from the
    profiler's raw events (building torch's event tree over the ~10^6
    events of a matrix-free window takes minutes)."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._summarize(self._prof.profiler.kineto_results.events())
        return False

    def _summarize(self, events):
        """Kernels (and copies) are the device events that are not
        ranges; a profiler range's device time is the time of the
        kernels that start inside its device-side span (one stream)."""
        from torch.autograd import DeviceType

        cpu, kernels, spans = [], [], defaultdict(list)
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CPU:
                cpu.append((s, s + d, e.name()))
            elif e.is_user_annotation():
                spans[e.name()].append((s, s + d))
            else:
                kernels.append((e.name(), s * 1e-3, d * 1e-3))
        kernels.sort(key=lambda k: k[1])
        self.kernels = kernels
        starts = [k[1] for k in kernels]
        sums = [0.0]
        for _, _, d in kernels:
            sums.append(sums[-1] + d)
        self.ranges = {}
        for name, ivs in spans.items():
            total = 0.0
            for a, b in ivs:
                i = bisect.bisect_left(starts, a * 1e-3)
                j = bisect.bisect_right(starts, b * 1e-3)
                total += sums[j] - sums[i]
            self.ranges[name] = total * 1e-6
        merged = _union((s, s + d) for _, s, d in kernels)
        self.busy_s = sum(b - a for a, b in merged) * 1e-6
        cpu.sort()
        self.breakdown = {"device_ops": _top_ops(kernels),
                          "idle_gaps": _top_gaps(merged, cpu)}


def _union(intervals):
    out = []
    for a, b in intervals:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_ops(kernels, k: int = 10):
    tot = defaultdict(float)
    for name, _, d in kernels:
        tot[name] += d * 1e-6
    return [[n[:200], s] for n, s in sorted(tot.items(),
                                             key=lambda x: -x[1])[:k]]


def _top_gaps(merged, cpu, k: int = 10):
    """The k longest gaps between kernels (microseconds), each named by
    the innermost host operation running where it starts; `cpu` holds
    (start ns, end ns, name), sorted."""
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])),
                  reverse=True)[:k]
    starts = [c[0] for c in cpu]
    out = []
    for length, at in gaps:
        ns = at * 1e3
        inner = None
        for s, e, name in cpu[:bisect.bisect_right(starts, ns)]:
            if ns < e and (inner is None or s >= inner[0]):
                inner = (s, name)
        out.append([(inner[1] if inner else "host")[:200], length * 1e-6])
    return out
