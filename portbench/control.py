"""The control of the check that decides ``correct``, run at a cell's own
size: a path that breaks a guarantee the configuration states, put in
the program's place, over a few seeds, each run as the benchmark runs
the cell with a short window. It must come out not correct on every seed;
its smallest reading is the compared number's upper reading.

* a cell of ``.rl_bwt`` output: the program with its own RLE-quirk path
  switched on (``CONTROL``), whose .rl_bwt repeats residual runs per
  class, so it is not the exact run-length BWT;
* a cell of ``.bwt`` output, on which the quirk does nothing: the plain
  reference in the program's place (``unordered_transform``) with every
  separator one value, ordered by what follows it and not by document
  order, the sort a faster one-terminator suffix sort would make.

    python3 portbench/control.py --workload <cell> --seconds 3 \
        --seed <n> [--seed <n> ...]

Prints one JSON line a seed: the seed, ``correct`` and the checks.
"""
import pathlib
import sys

if __name__ == "__main__":
    sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from portbench import guard  # noqa: E402

guard.install()

import argparse  # noqa: E402
import json  # noqa: E402
import types  # noqa: E402

from portbench import harness, reference  # noqa: E402

CONTROL = {"replicate_reference_rle_quirk": True}


def unordered_bwt(sx):
    """SX's BWT with every separator one value below every other byte
    (byte 1, which SX does not hold), so that separators and the suffixes
    that meet them sort by what follows."""
    flat = sx.clone()
    flat[sx == reference.SEPARATOR] = 1
    sa = reference.suffix_array(flat)
    del flat
    return sx[(sa - 1) % max(int(sx.numel()), 1)]


def unordered_transform(self, collection, rle=False, backend=None):
    """CMSBWT.transform's place: the .bwt of ``unordered_bwt``, worked out
    on the model's device from the collection file."""
    sx = reference.collection_string(reference.read_file(collection,
                                                         self.device))
    out = unordered_bwt(sx).cpu().numpy().tobytes()
    return types.SimpleNamespace(bwt=out, rle=None, sn=int(sx.numel()),
                                 timer=types.SimpleNamespace(phases={}))


def run(root, name: str, seed: int, seconds: float,
        device: str = "cuda") -> dict:
    """One run of cell ``name`` with its control in the program's place."""
    _, _, traffic, _ = harness.definitions(root, name)
    if traffic["output"] == "rl_bwt":
        return harness.run_cell(root, name, seed, seconds, False,
                                device=device, program=CONTROL)
    from cmsbwt_tpu_torch.models.cms_bwt import CMSBWT
    saved = CMSBWT.transform
    CMSBWT.transform = unordered_transform
    try:
        return harness.run_cell(root, name, seed, seconds, False,
                                device=device)
    finally:
        CMSBWT.transform = saved


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    for seed in a.seed:
        line = run(harness.ROOT, a.workload, seed, a.seconds)
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
