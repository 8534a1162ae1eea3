"""The benchmark's idle attribution (port_bench/stages.py) on made-up
profiler events: every idle instant of the card goes to the innermost
program range open on the host, and the buckets add up to the window
less the kernels' union. The card's trace is read the same way."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench import manifest, stages
from port_bench.trace import Traced

CPU, GPU = DeviceType.CPU, DeviceType.CUDA


class Ev:
    """A profiler event as `kineto_results.events()` gives it (times
    in us here, ns there); `corr` links a launch to its work."""

    def __init__(self, name, dev, start_us, dur_us, ann=False, corr=0):
        self._n, self._d, self._s, self._u, self._a = (
            name, dev, int(start_us * 1000), int(dur_us * 1000), ann)
        self._c = corr

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def is_user_annotation(self):
        return self._a


def idle(events):
    """(buckets in us, window us, kernels' union us) of made-up events."""
    t = Traced()
    t._summarize(events)
    cpu, device = stages.read(events)
    got = stages.idle_by_range(cpu, device)
    window = (max(c[1] for c in cpu) - min(c[0] for c in cpu)) * 1e-3
    return ({k: v * 1e6 for k, v in got.items()}, window, t.busy_s * 1e6)


def k(start, dur, name="k", corr=0):
    return Ev(name, GPU, start, dur, corr=corr)


def launch(start, corr):
    return Ev("cudaLaunchKernel", CPU, start, 2, corr=corr)


def r(name, start, dur):
    return Ev(name, CPU, start, dur, ann=True)


def test_nested_ranges_charge_the_innermost():
    got, _, _ = idle([
        r("iterative_fit.value_and_grad", 0, 100),
        r("iterative._pivchol", 20, 40),            # 20-60
        Ev("aten::mm", CPU, 30, 10),                # not a program range
        k(0, 10), k(40, 10), k(70, 30),
    ])
    # idle 10-40 and 50-70: 10-20 and 60-70 in the evaluation, 20-40
    # and 50-60 in the pivoted Cholesky (aten::mm is not a stage)
    assert got["iterative_fit.value_and_grad"] == pytest.approx(20)
    assert got["iterative._pivchol"] == pytest.approx(30)
    assert got[stages.OUTSIDE] == pytest.approx(0)


def test_a_gap_across_siblings_is_split_between_them():
    got, _, _ = idle([
        r("serve.request", 0, 100),
        r("serve.posterior", 10, 40),               # 10-50
        r("serve.to_host", 50, 40),                 # 50-90
        k(0, 30), k(80, 20),
    ])
    # one gap, 30-80: 20 in the posterior, 30 in the copy to the host
    assert got["serve.posterior"] == pytest.approx(20)
    assert got["serve.to_host"] == pytest.approx(30)
    assert got["serve.request"] == pytest.approx(0)


def test_overlapping_ranges_on_two_threads_take_the_latest_start():
    got, _, _ = idle([
        r("iterative.slq_logdet_batched", 0, 60),
        r("iterative_fit.chain_rule", 40, 60),      # 40-100, another thread
        k(0, 20), k(90, 10),
    ])
    assert got["iterative.slq_logdet_batched"] == pytest.approx(20)
    assert got["iterative_fit.chain_rule"] == pytest.approx(50)


def test_leading_and_trailing_idle_count():
    got, window, busy = idle([
        Ev("aten::empty", CPU, 0, 5),
        r("iterative._grad_contraction", 10, 80),   # 10-90
        Ev("cudaDeviceSynchronize", CPU, 90, 20),   # ends at 110
        k(30, 40),
    ])
    # 0-10 and 90-110 with no range open, 10-30 and 70-90 inside it
    assert window == pytest.approx(110) and busy == pytest.approx(40)
    assert got[stages.OUTSIDE] == pytest.approx(30)
    assert got["iterative._grad_contraction"] == pytest.approx(40)


def test_kernels_past_the_host_events_are_clipped_to_the_window():
    got, window, _ = idle([
        r("serve.request", 10, 80),                 # the window: 10-90
        k(0, 20), k(50, 10), k(89, 5), k(95, 5),
    ])
    assert window == pytest.approx(80)
    assert got == {"serve.request": pytest.approx(59),
                   stages.OUTSIDE: pytest.approx(0)}


@pytest.mark.parametrize("skew", [0, -3000, 2500])
def test_gaps_are_placed_on_the_host_clock_by_their_launches(skew):
    """The card's clock runs `skew` us off the host's: each gap moves
    with the launch of the work that ends it, so the split is the same
    as with one clock."""
    events = [r("iterative_fit.value_and_grad", 0, 10000),
              r("iterative._pivchol", 1000, 3000),        # 1000-4000
              r("iterative.slq_logdet_batched", 6000, 3000),
              Ev("aten::add", CPU, 9990, 20)]              # ends at 10010
    for i, (at, dur) in enumerate([(100, 400), (2000, 100), (6500, 3000)]):
        events += [launch(at - 5, i + 1), k(at + skew, dur, corr=i + 1)]
    got, window, busy = idle(events)
    # on the host's clock the card idles until each launch: 0-95,
    # 495-1995, 2095-6495 and 9495-10010; the pivoted Cholesky holds
    # 1000-1995 and 2095-4000 of it, SLQ 6000-6495
    assert got["iterative._pivchol"] == pytest.approx(995 + 1905)
    assert got["iterative.slq_logdet_batched"] == pytest.approx(495)
    assert sum(got.values()) == pytest.approx(window - busy)


def test_work_with_no_launch_or_launched_before_its_gap_keeps_the_shift():
    events = [r("serve.posterior", 0, 1000), r("serve.to_host", 1000, 1000),
              launch(95, 1), k(100 - 2000, 100, corr=1),   # shift -2000
              Ev("aten::mm", CPU, 1190, 5, corr=2),        # not a launch
              k(1200 - 2000, 100, corr=2),                  # no launch
              launch(150, 3), k(1600 - 2000, 100, corr=3)]  # queued early
    got, _, _ = idle(events)
    # on the host's clock: work at 95-195, 1195-1295, 1595-1695
    assert got["serve.posterior"] == pytest.approx(95 + 805, abs=1)
    assert got["serve.to_host"] == pytest.approx(195 + 300 + 305, abs=1)


def test_a_gap_with_no_range_open_goes_outside():
    got, _, _ = idle([
        r("serve.request", 0, 20),
        Ev("aten::copy_", CPU, 30, 10),             # the client's own work
        r("serve.request", 50, 20),
        k(0, 20), k(50, 20),
    ])
    assert got == {"serve.request": pytest.approx(0),
                   stages.OUTSIDE: pytest.approx(30)}


def test_the_buckets_add_up_to_the_window_less_the_kernels():
    events = [r("iterative_fit.value_and_grad", 5, 190),
              r("iterative._pivchol", 10, 50),
              r("iterative.whitened_solve_info", 60, 60),
              r("iterative.precond_sqrt_pieces", 61, 9),
              r("iterative.slq_logdet_batched", 120, 40),
              Ev("aten::add", CPU, 0, 3), Ev("aten::sum", CPU, 196, 7)]
    events += [k(s, 3) for s in range(2, 200, 7)]
    events += [k(100, 30), k(110, 5)]               # overlapping kernels
    got, window, busy = idle(events)
    assert window == pytest.approx(203)
    assert sum(got.values()) == pytest.approx(window - busy)
    assert all(v >= 0 for v in got.values())


def run_of(events, items=4):
    """A traced run over made-up events, counting the reads of them."""
    t = Traced()
    t._summarize(events)
    calls = []

    def read():
        calls.append(1)
        return events
    t._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=read)))
    return SimpleNamespace(trace=t, record=SimpleNamespace(
        items=[None] * items)), calls


def test_per_item_reads_divide_by_the_window_s_answers_and_read_once():
    run, calls = run_of([r("iterative._pivchol", 0, 100), k(0, 20)],
                        items=4)
    assert stages.idle_ms_per_item(run, "iterative._pivchol") == \
        pytest.approx(80e-3 / 4)
    assert stages.idle_ms_per_item(run, stages.OUTSIDE) == 0.0
    assert len(calls) == 1
    # a range the program never opened (a program without it) reads None
    assert stages.idle_ms_per_item(run, "iterative_fit.chain_rule") is None
    assert stages.idle_ms_per_item(SimpleNamespace(trace=None),
                                   "iterative._pivchol") is None


NEW = ["pivchol_ms", "cg_ms", "slq_ms", "idle_ms.pivchol", "idle_ms.whiten",
       "idle_ms.cg", "idle_ms.slq", "idle_ms.contraction",
       "idle_ms.chain_rule", "idle_ms.eval", "idle_ms.outside.fit",
       "idle_ms.to_device", "idle_ms.posterior", "idle_ms.to_host",
       "idle_ms.request", "idle_ms.outside.predict"]


def _stage_events():
    """Every range the benchmark reads, each with a kernel and a gap in
    its device-side span."""
    names = ["iterative_fit.value_and_grad", "iterative._pivchol",
             "iterative.whitened_solve_info",
             "iterative.precond_sqrt_pieces", "iterative.slq_logdet_batched",
             "iterative._grad_contraction", "iterative_fit.chain_rule",
             "serve.request", "serve.to_device", "serve.posterior",
             "serve.to_host"]
    out = [Ev("aten::empty", CPU, 0, 1)]
    for i, n in enumerate(names):
        s = 10 + 100 * i
        out += [r(n, s, 50), Ev(n, GPU, s + 5, 20, ann=True), k(s + 10, 10)]
    return out


@pytest.mark.parametrize("metric", NEW)
def test_each_new_metric_reads_a_traced_window_and_none_untraced(metric):
    entry = next(m for m in manifest.benchmark()["per_layer"]
                 if m["name"] == metric)
    assert entry["source"] == "device_trace" and entry["unit"] == "ms"
    read = manifest.reader(metric)
    run, _ = run_of(_stage_events())
    value = read(run)
    assert value is not None and value > 0
    assert read(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("metric", [m for m in NEW if ".outside." not in m])
def test_each_stage_metric_is_silent_where_its_range_is_missing(metric):
    """The parent program, which lacks a range, gives no number for it
    and does not raise."""
    run, _ = run_of([Ev("aten::empty", CPU, 0, 100), k(10, 10)])
    assert manifest.reader(metric)(run) is None
