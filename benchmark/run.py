"""Run one cell of the benchmark of ``simplepath_tpu_torch`` and print its
result as the last line of standard output.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are ``benchmark/cells/*.json``; ``BENCHMARK.json`` at the root
lists them with their metrics.  A run needs as many CUDA devices as its cell
asks for, and exits non-zero without a result otherwise.
"""

import os
import sys
import time

STARTED = time.time()
# one host thread for the program's and numpy's CPU ops: the cells are paced
# by the host's launches, which other busy threads on the same cores slow
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
