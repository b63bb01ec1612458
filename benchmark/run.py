"""Entry point: ``python -m benchmark.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``, run from the root of a checkout.

Set-up is timed from here, before torch is imported. The environment keeps
libraries that could load JAX by themselves from doing so.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
os.environ.setdefault("USE_JAX", "0")

if __name__ == "__main__":
    from benchmark.harness import main
    sys.exit(main(sys.argv[1:], T0))
