"""Run one benchmark cell once and print its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells are BENCHMARK.json's workloads;
harness.py says what a run does. Exits non-zero, printing no result, when
no CUDA card (or fewer than the cell asks for) is visible, and when JAX or
the JAX package was imported."""
import time

T0 = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)

from portbench import guard  # noqa: E402

guard.install()

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
