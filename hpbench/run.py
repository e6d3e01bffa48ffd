"""Run one cell of the port's benchmark once and print its result line.

    python3 hpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``src/repro_torch``.  The
kernels build once into ``build/`` inside the checkout, and every later run
there loads them.  Exits non-zero, with no result, without a CUDA card or
with fewer cards than the cell asks for.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the run writes stays at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from hpbench.harness import main
    sys.exit(main(t0=T0))
