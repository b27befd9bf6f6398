"""The benchmark of the PyTorch port on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as one JSON line, last on standard output: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
from a profiled window. It exits with a code other than 0, and prints no
result, without enough CUDA cards for the cell, or where the run loaded
JAX or the JAX package.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(STARTED))
