"""Run one cell of the benchmark once.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout; see benchmark/README.md.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmark import harness

    os.environ.update(harness.cache_env(ROOT))
    sys.exit(harness.main(t_start=T_START))
