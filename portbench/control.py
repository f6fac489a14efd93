"""The control of the check that decides ``correct``, run at a cell's own
size: the program with its own path that breaks the configuration's
guarantee switched on (``CONTROL``: the RLE quirk, whose .rl_bwt repeats
residual runs per class, so it is not the exact run-length BWT), over a
few seeds, each run as the benchmark runs the cell with a short window.
It must come out not correct on every seed; its smallest reading is the
compared number's upper reading.

    python3 portbench/control.py --workload <cell> --seconds 3 \
        --seed <n> [--seed <n> ...]

Prints one JSON line a seed: the seed, ``correct`` and the checks.
"""
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import guard  # noqa: E402

guard.install()

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import harness  # noqa: E402

CONTROL = {"replicate_reference_rle_quirk": True}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    for seed in a.seed:
        line = harness.run_cell(harness.ROOT, a.workload, seed, a.seconds,
                                False, program=CONTROL)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
