"""The benchmark's command, run from the root of a checkout:

    python3 rag_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, and each number
compared beside its limit as the last lines of standard error."""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for rag_bench) and src (for the port), in place of
# this file's own folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from rag_bench import harness

    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
