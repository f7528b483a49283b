"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cells, their configurations, traffic
and metrics are in ``BENCHMARK.json``; see ``benchmark/README.md``.
"""

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
