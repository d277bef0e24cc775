"""Run one cell of the benchmark of tabmat_torch on a CUDA card.

    python3 glmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of the repository.  The last line of standard output is the
result, one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the repository's root in place of this script's folder, whose modules
# are loaded only through the glmbench package
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from glmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
