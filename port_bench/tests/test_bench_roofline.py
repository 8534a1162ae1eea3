"""The work counts and bounds against hand-worked shapes."""

import pytest

from port_bench import roofline


def test_gram_work_by_hand():
    # 2 x 3 entries over 3 features: 6 outputs and 5 points of 3 floats
    assert roofline.gram_work(2, 3, 3) == (4.0 * (6 + 15), 6 * 11.0, 12.0,
                                           0.0)


def test_matmat_work_by_hand():
    # n = 4, b = 2: points padded to 4 floats, V and Y once
    nbytes, fp32, sfu, tensor = roofline.matmat_work(4, 3, 2)
    assert nbytes == 4.0 * 4 * (4 + 4)
    assert fp32 == 16 * 10.0 and sfu == 32.0
    assert tensor == 3 * 2.0 * 16 * 2


def test_bound_takes_the_largest_term():
    rates = {"sms": 132, "clock_hz": 1.98e9}
    ms, term = roofline.bound((3.35e9, 0.0, 0.0, 0.0), **rates)
    assert term == "bytes" and ms == pytest.approx(1.0)
    ms, term = roofline.bound((0.0, 0.0, 0.0, 495e9), **rates)
    assert term == "tensor" and ms == pytest.approx(1.0)
    # K3 at the iterative serving cell's width is tensor-bound
    _, term = roofline.bound(roofline.matmat_work(100000, 3, 256), **rates)
    assert term == "tensor"


def test_sfu_split_balances_the_two_units():
    rates = {"sms": 132, "clock_hz": 1.98e9}
    work = roofline.gram_work(65536, 65536, 3)
    mufu_only, balanced = roofline.sfu_fma_ms(work, **rates)
    assert balanced <= mufu_only
    # with no ex2 to move, the two agree
    assert roofline.sfu_fma_ms((0, 1e9, 0, 0), **rates)[0] == \
        pytest.approx(roofline.sfu_fma_ms((0, 1e9, 0, 0), **rates)[1])
