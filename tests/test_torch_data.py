"""Port parity: data IO + standardization (gp_ss_ak_torch.data vs
gp_ss_ak_tpu.data). Both are float64 numpy code, so values must be
EXACTLY equal and written files byte-identical."""

import os

import numpy as np
import pytest

import gp_ss_ak_tpu.data as jd
import gp_ss_ak_torch.data as td

HERE = os.path.join(os.path.dirname(__file__), "golden")
RNG = np.random.default_rng(101)


def _xy(n=40, d=3):
    X = RNG.uniform(-50.0, 250.0, size=(n, d))
    y = np.sin(X[:, 0] / 40.0) + 0.1 * RNG.normal(size=n)
    return X, y


@pytest.mark.parametrize("name", ["train.txt", "test.txt"])
def test_read_golden_files_equal(name):
    Xj, yj = jd.read_data(os.path.join(HERE, name))
    Xt, yt = td.read_data(os.path.join(HERE, name))
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)


def test_read_comma_tab_comments_ragged(tmp_path):
    p = tmp_path / "mixed.txt"
    p.write_text("# header\n1,2,3,4\n5\t6\t7\t8\n\n# c\n9, 10 ,11\n")
    Xj, yj = jd.read_data(str(p))
    Xt, yt = td.read_data(str(p))
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("mode", [jd.MODE_MEANSTD, jd.MODE_SYMMETRIC,
                                  jd.MODE_ZERO_ONE])
@pytest.mark.parametrize("d", [3, 4])
def test_prepare_apply_unapply_equal(mode, d):
    X, y = _xy(d=d)
    Xsj, ysj, sj = jd.prepare(X, y, mode)
    Xst, yst, st = td.prepare(X, y, mode)
    np.testing.assert_array_equal(Xst, Xsj)
    np.testing.assert_array_equal(yst, ysj)
    np.testing.assert_array_equal(st.as_matrix(), sj.as_matrix())
    Xq, _ = _xy(n=7, d=d)
    np.testing.assert_array_equal(td.apply(st, Xq), jd.apply(sj, Xq))
    v = RNG.uniform(0.01, 0.5, size=7)
    np.testing.assert_array_equal(td.unapply_y(st, v), jd.unapply_y(sj, v))
    np.testing.assert_array_equal(td.unapply_var(st, v),
                                  jd.unapply_var(sj, v))
    np.testing.assert_array_equal(td.unapply_x(st, Xq),
                                  jd.unapply_x(sj, Xq))


def test_bad_mode_raises():
    X, y = _xy()
    with pytest.raises(ValueError):
        td.prepare(X, y, 7)


def test_statistics_file_byte_identical(tmp_path):
    X, y = _xy(d=4)
    _, _, sj = jd.prepare(X, y, jd.MODE_SYMMETRIC)
    _, _, st = td.prepare(X, y, td.MODE_SYMMETRIC)
    sj.save(str(tmp_path / "j_Statistics.txt"))
    st.save(str(tmp_path / "t_Statistics.txt"))
    assert (tmp_path / "t_Statistics.txt").read_bytes() == \
        (tmp_path / "j_Statistics.txt").read_bytes()
    back = td.Statistics.load(str(tmp_path / "t_Statistics.txt"))
    np.testing.assert_array_equal(back.as_matrix(), st.as_matrix())


def test_golden_statistics_load_equal():
    p = os.path.join(HERE, "model_Statistics.txt")
    np.testing.assert_array_equal(td.Statistics.load(p).as_matrix(),
                                  jd.Statistics.load(p).as_matrix())


def test_write_data_and_predictions_byte_identical(tmp_path):
    X, y = _xy(n=25)
    jd.write_data(str(tmp_path / "j.txt"), X, y)
    td.write_data(str(tmp_path / "t.txt"), X, y)
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    yh = y + 0.01 * RNG.normal(size=y.shape)
    std = RNG.uniform(0.05, 0.2, size=y.shape)
    oj = jd.write_predictions(str(tmp_path / "jp.txt"), y, yh, std, X)
    ot = td.write_predictions(str(tmp_path / "tp.txt"), y, yh, std, X)
    np.testing.assert_array_equal(ot, oj)
    assert (tmp_path / "tp.txt").read_bytes() == \
        (tmp_path / "jp.txt").read_bytes()
