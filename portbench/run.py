"""Run one cell of ``BENCHMARK.json`` on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON result line last on
standard output, and each number compared with its limit last on
standard error. Exits non-zero without a card, and when JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One OpenMP thread: the card does the arithmetic and the host only
# launches it; a pool of idle threads made host-bound runs spread wider.
os.environ["OMP_NUM_THREADS"] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root and its src/, in place of this file's directory
# (whose module names would shadow the standard library's).
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
