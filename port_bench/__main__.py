"""python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

T_PROC = time.perf_counter()

import sys  # noqa: E402

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_proc=T_PROC))
