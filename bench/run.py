"""Run one cell of the benchmark on this machine's card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the lines
before it and ``build/bench/<cell>/s<seed>-t<trace>.json`` hold the rest.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
