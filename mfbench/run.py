"""Run one benchmark cell once and print its result line:

    python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m mfbench.run`` from the checkout's root is the same.)  Exits
non-zero, with no result, without as many CUDA cards as the cell asks for,
without the program beside it, or when the run has loaded JAX."""

import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from mfbench.harness import main
else:
    from .harness import main

if __name__ == "__main__":
    main()
