"""The benchmark of henjou_torch, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. See hbench/runner.py."""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# the benchmark's packages (hbench, plainref) and the program at the root
sys.path[:0] = [_HERE, os.path.dirname(_HERE)]

from hbench.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
