"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations
and metrics. Everything that belongs to one of them is a file of its own
under this folder, found by that name:

    configs/<config>.json      sizes, model, hyperparameters, source,
                               and the plain reference it is judged by
    workloads/<cell>.json      its configuration, traffic and limits
    traffic/<traffic>.json     the mix: which loop, with its parameters
    loops/<loop>.py            the loop that drives the program and
                               judges its answers (`LOOP`)
    reference/<module>.py      a plain reference of a model
    metrics/<metric>.py        a reader, `read(run)` -> number or None

so a later cell, mix or metric is new files and entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not NAME.match(name or ""):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    """The manifest's entry for `workload`, joined with its files:
    {"name", "chips", "config": {...}, "traffic": {...}, "limits",
    "metrics_e2e", "metrics_layer"}, each metric entry from the manifest."""
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    spec = _json(HERE / "workloads" / f"{_name('workload', workload)}.json")
    if spec["config"] != entry["config"] or spec["traffic"] != entry["traffic"]:
        raise ValueError(f"workloads/{workload}.json disagrees with "
                         "BENCHMARK.json on its config or traffic")
    config = _json(HERE / "configs" / f"{_name('config', entry['config'])}.json")
    traffic = _json(HERE / "traffic"
                    / f"{_name('traffic', entry['traffic'])}.json")

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {"name": workload, "chips": int(entry["chips"]),
            "config": config, "traffic": traffic, "spec": spec,
            "metrics_e2e": [m for m in bench["end_to_end"] if mine(m)],
            "metrics_layer": [m for m in bench["per_layer"] if mine(m)]}


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = HERE / "metrics" / f"{_name('metric', metric)}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _module(package: str, name: str):
    if not MODULE.match(name or ""):
        raise ValueError(f"bad {package} module name {name!r}")
    return importlib.import_module(f"port_bench.{package}.{name}")


def loop(name: str):
    """The loop class of loops/<name>.py."""
    return _module("loops", name).LOOP


def reference(name: str):
    """The plain reference module reference/<name>.py."""
    return _module("reference", name)
