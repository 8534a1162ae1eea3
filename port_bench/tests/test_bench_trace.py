"""The trace summary on made-up profiler events (the card's trace is
read the same way on the chip)."""

import pytest
from torch.autograd import DeviceType

from port_bench.trace import Traced


class Ev:
    def __init__(self, name, dev, start_us, dur_us, ann=False):
        self._n, self._d, self._s, self._u, self._a = (
            name, dev, int(start_us * 1000), int(dur_us * 1000), ann)

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


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def summary():
    t = Traced()
    t._summarize([
        Ev("iterative._grad_contraction", CPU, 0, 100, ann=True),
        Ev("aten::mm", CPU, 10, 5),
        Ev("cudaStreamSynchronize", CPU, 60, 30),
        Ev("k_a", GPU, 20, 10),
        Ev("k_b", GPU, 25, 15),          # overlaps k_a: union 20-40
        Ev("iterative._grad_contraction", GPU, 20, 45, ann=True),
        Ev("k_c", GPU, 50, 10),          # inside the range's span
        Ev("k_a", GPU, 80, 5),           # after it
    ])
    return t


def test_busy_is_the_union_of_kernels():
    t = summary()
    assert t.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert len(t.kernels) == 4


def test_range_time_sums_the_kernels_inside_its_span():
    assert summary().ranges["iterative._grad_contraction"] == \
        pytest.approx((10 + 15 + 10) * 1e-6)


def test_breakdown_orders_ops_and_names_gaps_by_the_host():
    b = summary().breakdown
    assert b["device_ops"][0] == ["k_a", pytest.approx(15e-6)]
    # gaps 60-80 (20 us, the host in cudaStreamSynchronize) and 40-50
    assert b["idle_gaps"][0] == ["cudaStreamSynchronize",
                                 pytest.approx(20e-6)]
    assert b["idle_gaps"][1][1] == pytest.approx(10e-6)
