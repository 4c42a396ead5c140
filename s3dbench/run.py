"""The benchmark's one command: one run of one cell.

    python3 s3dbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (``harness``); see README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT          # import s3dbench and the program as packages

from s3dbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
