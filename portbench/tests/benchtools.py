"""Helpers of the benchmark's tests: a copy of the benchmark with tiny
cells, driven on the CPU."""
import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = {
    "tiny_one": {"generator": {"reference_bp": 3000, "documents": 6,
                               "substitution_rate": 0.01}},
    "tiny_batches": {"generator": {"reference_bp": 2000, "documents": 12,
                                   "documents_per_file": 4,
                                   "substitution_rate": 0.002}},
}
# the repository's cells, each with a tiny stand-in of its traffic
CELLS = {"ecoli100_r": ("tiny_e", "tiny_one"),
         "sars10k_r": ("tiny_s", "tiny_batches")}


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def tiny_copy(dst: pathlib.Path) -> pathlib.Path:
    """A checkout of the benchmark alone (BENCHMARK.json and portbench/)
    in ``dst`` whose cells are the repository's at tiny sizes: each cell
    renamed (CELLS), on its own traffic, with a tiny configuration."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    names = {}
    for w in b["workloads"]:
        new, conf = CELLS[w["name"]]
        names[w["name"]] = new
        w["name"], w["config"] = new, conf
    b["configs"] = [{"name": k, "source": "tiny", "reduced": [],
                     "file": f"portbench/configs/{k}.json", "why": "tiny"}
                    for k in TINY]
    for k, v in TINY.items():
        (dst / "portbench" / "configs" / f"{k}.json").write_text(
            json.dumps(v))
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [names[c] for c in m["workloads"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(b, indent=1))
    return dst


def run_tiny(root, cell, seed=2**31 + 11, seconds=0.5, trace=False):
    from portbench import guard, harness
    guard.install()
    return harness.run_cell(pathlib.Path(root), cell, seed, seconds, trace,
                            device="cpu")
