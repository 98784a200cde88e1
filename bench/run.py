"""Run one benchmark cell once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared for ``correct`` are the last
lines of standard error.  Exits non-zero, with no result, without a CUDA
card, when a module of the JAX package is loaded, or when the program
(``src/repro_torch``) is missing.
"""

import sys
import time

T_MAIN = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root (for ``bench``) and ``src`` (for the program), never
# ``bench/`` itself, whose module names would shadow the standard library's
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_MAIN))
