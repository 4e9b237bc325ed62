"""The benchmark of the PyTorch/CUDA port: one run of one cell of
``BENCHMARK.json``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1
"""

import time

START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness.cell import run

    sys.exit(run(sys.argv[1:], START))
