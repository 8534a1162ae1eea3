"""BENCHMARK.json against the benchmark's contract, and the discovery of
every cell's files by name."""

import json
import re

import pytest

from port_bench import manifest

BENCH = manifest.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_are_found_by_name(workload):
    cell = manifest.cell(BENCH, workload)
    assert cell["chips"] == 1
    assert cell["config"]["n"] > 0
    loop = manifest.loop(cell["traffic"]["loop"])
    assert all(callable(getattr(loop, f)) for f in (
        "setup", "warm", "first_predict", "window", "answers", "release",
        "numbers", "produce"))
    ref = manifest.reference(cell["config"]["reference"]["module"])
    assert {"F64", "CONTROL", "standardize", "factor"} <= set(vars(ref))
    e2e = [m["name"] for m in cell["metrics_e2e"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["metrics_layer"]
    for m in cell["metrics_e2e"] + cell["metrics_layer"]:
        assert callable(manifest.reader(m["name"]))
    for m in cell["metrics_layer"]:
        moves = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert workload in moves.get("workloads", [workload])
    assert set(cell["spec"]["limits"]) >= {"std_abs"}


def test_every_config_file_lies_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/configs/")
        assert json.load(open(manifest.ROOT / c["file"]))["reduced"] == []


def test_unknown_cell_and_bad_names_are_refused():
    with pytest.raises(KeyError):
        manifest.cell(BENCH, "no-such-cell")
    with pytest.raises(ValueError):
        manifest.reader("../harness")
    with pytest.raises(ValueError):
        manifest.loop("..harness")
    with pytest.raises(ModuleNotFoundError):
        manifest.reference("no_such_reference")
