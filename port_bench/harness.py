"""One run of one cell:

    python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

sets up the cell's loop, loops/<loop>.py as its traffic names it (data
from the seed, the program's objects),
warms every shape the window uses (set-up, `setup_s`), measures first
predictions where the cell has them, runs the window for `--seconds`
(under the profiler with `--trace 1`), reads the peak memory, frees the
program's state, has the loop compare the sampled answers with the
plain reference that the configuration names (reference/<module>.py),
checks that nothing of JAX or the JAX package was loaded, and prints one
JSON line last on standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or its per-layer metrics with
`--trace 1`), `device`, `breakdown` (traced runs) and `checks`, each
compared number beside its limit, which the last lines on standard
error repeat.

It runs on the card or not at all: without CUDA, or with fewer cards
than the cell asks for, it exits 2 and prints no result. It exits 3 and
prints no result when the no-JAX check fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from port_bench import manifest, nojax

#: exit codes with no result line
NO_CARD, FORBIDDEN_LOADED = 2, 3


class NoCard(RuntimeError):
    pass


class Run:
    """What the metric readers read (metrics/<name>.py: `read(run)`)."""

    def __init__(self, cell, loop, setup_s, record, first, traced):
        self.cell, self.loop = cell, loop
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.setup_s = setup_s
        self.record = record
        self.first_predict = first
        self.trace = traced


def _card(device: str, chips: int):
    """The card's name, after checking that the cell's cards are there."""
    import torch

    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise NoCard("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, "
                     f"{torch.cuda.device_count()} found")
    return torch.cuda.get_device_name(0)


def _smi() -> str:
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_proc: float, device: str = "cuda", control: bool = False,
        overrides=None, log=None):
    """One run; returns (result dict, check lines). With `control` the
    configuration's reference, in its control precision, takes the
    program's place before the comparison; `overrides` replace
    configuration, traffic or cell-file entries (tests at a small
    size)."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = manifest.cell(manifest.benchmark(), workload)
    for part, upd in (overrides or {}).items():
        cell[part] = dict(cell[part], **upd)
    kind = _card(device, cell["chips"])
    if device != "cpu":
        log(f"card: {_smi()}")
        torch.cuda.reset_peak_memory_stats()
    loop = manifest.loop(cell["traffic"]["loop"])(
        cell["traffic"], cell["config"], seed, device)
    loop.setup()
    loop.warm()
    setup_s = time.perf_counter() - t_proc
    first = loop.first_predict()
    traced = None
    if trace:
        from port_bench.trace import Traced

        with Traced() as traced:
            record = loop.window(seconds)
    else:
        record = loop.window(seconds)
        loop.sync()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    done = record.completed()
    log(f"window: {len(done)} of {len(record.items)} answers completed "
        "by the close")
    if loop.summary(record):
        log(loop.summary(record))
    answers = loop.answers(record, cell["spec"]["answers"]) if done else []
    r = Run(cell, loop, setup_s, record, first, traced)
    metrics = {}
    for m in cell["metrics_layer" if trace else "metrics_e2e"]:
        value = manifest.reader(m["name"])(r) if done else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loop.release()
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    if control and answers:
        answers = loop.produce(answers, loop.ref.CONTROL)
    limits = cell["spec"]["limits"]
    t_ref = time.perf_counter()
    got = loop.numbers(answers) if answers else {}
    log(f"reference: {time.perf_counter() - t_ref:.3f} s for "
        f"{len(answers)} sampled answers")
    checks = {k: {"value": _finite(got.get(k)), "limit": lim}
              for k, lim in limits.items()}
    correct = bool(done) and all(c["value"] is not None
                                 and c["value"] <= c["limit"]
                                 for c in checks.values())
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(done),
              "failed": sum(it.failed for it in done), "metrics": metrics,
              "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = traced.breakdown
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines


def _finite(v):
    """A compared number for the JSON line: None when it is missing or
    not finite (a NaN answer), which never passes."""
    return None if v is None or v != v or v in (float("inf"),
                                                 float("-inf")) else v


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m port_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_proc=None) -> int:
    t_proc = time.perf_counter() if t_proc is None else t_proc
    args = parse(argv)
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(manifest.ROOT / "build" / "triton"))
    try:
        result, lines = run(args.workload, args.seed % 2 ** 63,
                            args.seconds, bool(args.trace), t_proc)
    except NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return NO_CARD
    bad = nojax.violations()
    if bad:
        print("port_bench: the run loaded what it must not: "
              + "; ".join(bad), file=sys.stderr)
        return FORBIDDEN_LOADED
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
