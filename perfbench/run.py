"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the contract's JSON object as the
last line of standard output, and each correctness number beside its
limit as the last lines of standard error.  Exits non-zero, with no
result, without enough CUDA devices or when JAX or the JAX package was
loaded in this process.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
