"""Port parity: the native C++ data parser (gp_ss_ak_torch.native) and
`data.read_data`, which takes it first.

The port's parser must give exactly the table of the NumPy parser
(`data.io._parse_lines`: both round each token correctly, strtod and
float()) and of the JAX package's native parser. Its library builds
into build/native/ at first use; where g++ is missing the parser is
unavailable (`parse_file` returns None) and the fixture skips.
"""

import numpy as np
import pytest

from gp_ss_ak_tpu.native import loader as jloader
from gp_ss_ak_torch.data import io, read_data, write_data
from gp_ss_ak_torch.native import loader

RNG = np.random.default_rng(41)


@pytest.fixture(scope="module")
def built():
    if loader._load() is None:
        pytest.skip("native loader could not be built")
    return True


def _numpy_table(path):
    with open(path) as f:
        return io._parse_lines(f.read())


def test_table_equals_the_numpy_and_jax_parsers(built, tmp_path):
    X = RNG.normal(size=(300, 4)) * 10.0 ** RNG.integers(-6, 7, (300, 4))
    y = RNG.normal(size=300)
    p = str(tmp_path / "d.txt")
    write_data(p, X, y)
    table = loader.parse_file(p)
    assert table.shape == (300, 5) and table.dtype == np.float64
    np.testing.assert_array_equal(table, _numpy_table(p))
    jtable = jloader.parse_file(p)
    if jtable is not None:
        np.testing.assert_array_equal(table, jtable)


@pytest.mark.parametrize("text,want", [
    ("# header\n1,2,3\n# mid comment\n4\t5\t6\n", [[1, 2, 3], [4, 5, 6]]),
    ("1,2,3\n4,5\n", [[1, 2, 3], [4, 5, 0]]),
    ("1.5e-3, -2\t7\r\n\n3 4 5e2\n", [[1.5e-3, -2, 7], [3, 4, 500]]),
], ids=["comments_mixed_delims", "short_rows_zero_filled", "spaces_crlf"])
def test_formats(built, tmp_path, text, want):
    p = tmp_path / "m.txt"
    p.write_text(text)
    table = loader.parse_file(str(p))
    np.testing.assert_array_equal(table, np.asarray(want, np.float64))
    np.testing.assert_array_equal(table, _numpy_table(str(p)))


def test_missing_file_is_none_and_read_data_raises(built, tmp_path):
    assert loader.parse_file(str(tmp_path / "nope.txt")) is None
    with pytest.raises(FileNotFoundError):
        read_data(str(tmp_path / "nope.txt"))


def test_read_data_takes_the_native_parser(built, tmp_path, monkeypatch):
    X = RNG.normal(size=(50, 3))
    y = RNG.normal(size=50)
    p = str(tmp_path / "d.txt")
    write_data(p, X, y)
    want = read_data(p)

    def refuse(text):
        raise AssertionError("read_data fell back to the numpy parser")

    monkeypatch.setattr(io, "_parse_lines", refuse)
    X2, y2 = read_data(p)
    np.testing.assert_array_equal(X2, want[0])
    np.testing.assert_array_equal(y2, want[1])
    np.testing.assert_allclose(X2, X, rtol=1e-9)


def test_disabled_parser_falls_back_to_numpy(tmp_path, monkeypatch):
    p = str(tmp_path / "d.txt")
    write_data(p, RNG.normal(size=(20, 3)), RNG.normal(size=20))
    native = read_data(p)
    monkeypatch.setenv("GP_SS_AK_NO_NATIVE", "1")
    monkeypatch.setattr(loader, "_tried", False)
    monkeypatch.setattr(loader, "_lib", None)
    assert loader.parse_file(p) is None
    X, y = read_data(p)
    np.testing.assert_array_equal(X, native[0])
    np.testing.assert_array_equal(y, native[1])


def test_library_lives_in_the_build_directory(built):
    assert loader.BUILD_DIR.name == "native"
    assert loader.BUILD_DIR.parent.name == "build"
    assert any(loader.BUILD_DIR.glob("libgp_loader_*.so"))
