"""The end-to-end metrics' arithmetic on made-up timestamps."""

import pytest

from port_bench import window
from port_bench.window import Item, Record


def rec():
    r = Record(t_start=10.0, t_close=20.0)
    # answers ending at 12, 15, 19.5 and 21 (the last after the close)
    for t0, t1, pts in ((10.0, 12.0, 4), (12.1, 15.0, 4), (15.2, 19.5, 4),
                        (19.6, 21.0, 4)):
        r.items.append(Item(t0, t1, pts))
    return r


def test_completed_ends_by_the_close():
    assert [it.t_done for it in rec().completed()] == [12.0, 15.0, 19.5]


def test_rates_end_at_the_last_completion():
    assert window.span_s(rec()) == pytest.approx(9.5)
    assert window.per_item_ms(rec()) == pytest.approx(9500.0 / 3)
    assert window.points_per_s(rec()) == pytest.approx(12 / 9.5)


def test_p95_over_every_completed_request():
    # latencies 2.0, 2.9, 4.3 s: numpy's linear interpolation
    assert window.p95_ms(rec()) == pytest.approx(
        (2.9 + 0.9 * (4.3 - 2.9)) * 1e3)


def test_an_empty_window_has_no_rate():
    with pytest.raises(ValueError):
        window.span_s(Record(0.0, 1.0))
