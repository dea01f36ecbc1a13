"""Run one benchmark cell once on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of stdout is the result (JSON);
the numbers compared for ``correct`` are the last lines of stderr. Exits
non-zero, with no result, without enough CUDA devices, when a module of JAX
or of the JAX package is loaded, or when the program is absent.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
