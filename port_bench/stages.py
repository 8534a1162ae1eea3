"""Where the card's idle time goes: every idle instant of a traced
window charged to the program's stage that the host was in.

The card is idle where no kernel or copy runs (outside the union of
the kernels `Traced.kernels` holds), counted over the window from the
trace's first CPU event to its last, so that idle before the first
kernel and after the last counts too. An idle instant goes to the
innermost program range open on the host at that instant: of the CPU
ranges whose names start with `serve.`, `iterative.` or
`iterative_fit.` (the profiler ranges of gp_ss_ak_torch), the one with
the latest start, on any thread. A gap that spans several ranges is
split among them. An instant with no program range open goes to
`outside`. So the buckets add up to the window less the kernels' union
(up to the drift of the clocks, `_gaps`, over the window: milliseconds
in tens of seconds).

The per-stage readers (metrics/idle_ms.*.py) divide a bucket by the
window's answers, as `layer.range_ms_per_item` divides device time.
"""

from __future__ import annotations

import bisect
import heapq

#: the names of the program's ranges
PREFIXES = ("serve.", "iterative.", "iterative_fit.")
OUTSIDE = "outside"


def idle_by_range(cpu, device):
    """{range name or OUTSIDE: idle seconds} of one window.

    `cpu` holds every CPU event as (start ns, end ns, name); `device`
    every kernel or copy as (start ns, duration ns, start ns of the host
    call that launched it, None where unknown). A range that is open
    somewhere in the window has its entry, 0.0 if no idle fell in it;
    OUTSIDE always has one."""
    if not cpu:
        return {}
    lo = min(c[0] for c in cpu)
    hi = max(c[1] for c in cpu)
    ranges = [c for c in cpu if c[2].startswith(PREFIXES)]
    out = {n: 0.0 for _, _, n in ranges}
    out[OUTSIDE] = 0.0
    segs = _innermost(ranges, lo, hi)
    starts = [sg[0] for sg in segs]
    for g0, g1 in _gaps(device, lo, hi):
        g0, g1 = max(g0, lo), min(g1, hi)
        if g0 >= g1:
            continue
        # charge [g0, g1) to each piece it overlaps, in order
        j = bisect.bisect_right(starts, g0) - 1
        while g0 < g1:
            top = min(g1, segs[j][1])
            out[segs[j][2]] += (top - g0) * 1e-9
            g0, j = top, j + 1
    return out


def _gaps(device, lo, hi):
    """The card's idle gaps on the host's clock: the gaps of the device
    work's union, and before the first and after the last work within
    [lo, hi]. The two clocks of a trace drift apart by milliseconds
    over a window, so each gap is moved by the shift of the work that
    ends it: its start on the card less the start of its launch on the
    host, which the idle card waited for. Work that was launched before
    the gap began, or whose launch is unknown, keeps the last shift."""
    shift, end = 0, None
    for s, d, launch in sorted(device, key=lambda w: w[0]):
        if end is None or s > end:
            if launch is not None and (end is None
                                       or launch >= end - shift):
                shift = s - launch
            yield (lo if end is None else end - shift), s - shift
        end = s + d if end is None else max(end, s + d)
    yield (lo if end is None else end - shift), hi


def _innermost(ranges, lo, hi):
    """[lo, hi] cut into contiguous (start, end, name) pieces over which
    the innermost open range (latest start; of two that start together,
    the one that ends first) stays the same; OUTSIDE where none is
    open."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(ranges)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(ranges)])
    heap, closed, segs, t = [], set(), [], lo
    for at, opens, i in marks + [(hi, 0, None)]:
        at = min(max(at, lo), hi)
        while heap and heap[0][2] in closed:
            heapq.heappop(heap)
        if at > t:
            segs.append((t, at, ranges[heap[0][2]][2] if heap else OUTSIDE))
            t = at
        if i is None:
            break
        if opens:
            s, e, _ = ranges[i]
            heapq.heappush(heap, (-s, e, i))
        else:
            closed.add(i)
    return segs


def read(events):
    """(cpu, device) for `idle_by_range` from the profiler's raw events:
    the device work is every device event that is not a range (the set
    `Traced.kernels` holds), each with the start of the CUDA API call
    (`cuda*`, `cu*`: a CPU operator's correlation ids are another count)
    of the same correlation id."""
    from torch.autograd import DeviceType

    cpu, device, launch = [], [], {}
    for e in events:
        s, name = e.start_ns(), e.name()
        if e.device_type() == DeviceType.CPU:
            cpu.append((s, s + e.duration_ns(), name))
            if name.startswith("cu") and e.correlation_id():
                launch[e.correlation_id()] = s
        elif not e.is_user_annotation():
            device.append((s, e.duration_ns(), e.correlation_id()))
    return cpu, [(s, d, launch.get(c)) for s, d, c in device]


def idle_s(run):
    """The run's idle buckets (`idle_by_range`), read once from the raw
    events of the profiler `Traced` keeps and kept on the run; None for
    an untraced run."""
    if run.trace is None:
        return None
    if getattr(run, "idle_stages", None) is None:
        events = run.trace._prof.profiler.kineto_results.events()
        run.idle_stages = idle_by_range(*read(events))
    return run.idle_stages


def idle_ms_per_item(run, name: str):
    """Idle charged to range `name` (or OUTSIDE) per answer of the
    traced window, in ms; None where the window opened no such range (a
    program that lacks it)."""
    buckets = idle_s(run)
    if buckets is None or name not in buckets:
        return None
    return buckets[name] * 1e3 / len(run.record.items)
