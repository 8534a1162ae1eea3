"""Readings for the limits of `correct`, several seeds in one process:

    python -m port_bench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--program | --fault <name>]

Without `--program` each run puts the control in the program's place:
the configuration's plain reference in its `CONTROL` precision (for
reference/gp.py, TF32: every matrix product's operands rounded to
TF32's 10 mantissa bits), the nearest precision below the
configuration's float32. Its answers are compared
with the float64 reference exactly as a run compares the program's, and
a sound limit has to fail it. With `--program` the runs are the
program's own, for the lower readings; with `--fault <name>` the
program's, with one of the faults of tests/test_bench_cells.py
(`_<name>`) planted underneath the timed path, for a training cell's
upper readings. The benchmark's own runs never
run this. Prints one JSON line per seed: its compared numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _plant(fault):
    """A MonkeyPatch holding the fault `fault` planted, or None."""
    if fault is None:
        return None
    from _pytest.monkeypatch import MonkeyPatch

    from port_bench.tests import test_bench_cells

    mp = MonkeyPatch()
    getattr(test_bench_cells, f"_{fault}")(mp)
    return mp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault")
    args = p.parse_args(argv)
    program = args.program or args.fault is not None

    from port_bench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        mp = _plant(args.fault)
        try:
            result, _ = harness.run(
                args.workload, seed, args.seconds, False,
                time.perf_counter(), control=not program)
        finally:
            if mp is not None:
                mp.undo()
        print(json.dumps({"seed": seed, "control": not program,
                          "fault": args.fault,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
