"""Run one cell of the port's benchmark once, on the card this machine has:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the checks of the comparison as the
last lines of standard error and one JSON result as the last line of
standard output; exits non-zero with no result where the card is missing
or a run loaded JAX or the JAX package.  ``harness.py`` says what a run
does.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

# one process with one host thread a library: the host's share of a batch
# then varies less from run to run
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
