"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards.  The
last line of standard output is the result (see harness.py); the
compared numbers and their limits are the last lines of standard error.
"""

import os
import sys
import time

if __name__ == "__main__":
    T_START = time.perf_counter()
    # import the benchmark as a package from the checkout's root, never
    # its files as top-level modules
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from portbench import harness
    harness.set_cache_dirs()
    sys.exit(harness.main(t_start=T_START))
