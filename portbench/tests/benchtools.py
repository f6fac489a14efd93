"""Helpers of the benchmark's tests: a copy of the benchmark with tiny
cells, driven on the CPU.

Every cell of BENCHMARK.json gets a tiny stand-in on its own traffic. The
two first cells keep the stand-ins their tests were written for
(``CELLS``, on the configurations of ``TINY``); any other cell becomes
``tiny_<cell>``, on ``tiny_<config>``, whose sizes ``tiny_generator``
derives from its configuration's ``generator``. A cell added with its
files and BENCHMARK.json entries thus has a stand-in with no edit here.
"""
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
# cells whose stand-ins are set by hand: (stand-in, configuration of TINY)
CELLS = {"ecoli100_r": ("tiny_e", "tiny_one"),
         "sars10k_r": ("tiny_s", "tiny_batches")}
NAME_MAX = 64


def bench(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def tiny(name: str) -> str:
    """The stand-in's name of a cell or a configuration."""
    return ("tiny_" + name)[:NAME_MAX]


def tiny_generator(g: dict) -> dict:
    """A configuration's ``generator`` at a tiny size: the reference at most
    3000 bp, at most 12 documents, at most 4 a file where the files are
    batches, an N run of at most an eighth of the reference where there is
    one; the substitution rate, the line width and any other key kept."""
    t = dict(g)
    t["reference_bp"] = min(g["reference_bp"], 3000)
    t["documents"] = min(g["documents"], 12)
    if g.get("documents_per_file"):
        t["documents_per_file"] = min(g["documents_per_file"], 4)
    if g.get("n_run", 0) > 0:
        t["n_run"] = max(1, min(g["n_run"], t["reference_bp"] // 8))
    return t


def stand_ins(b: dict) -> dict:
    """{cell: (stand-in, its configuration)} for every cell of ``b``."""
    out = {w["name"]: CELLS.get(w["name"], (tiny(w["name"]),
                                            tiny(w["config"])))
           for w in b["workloads"]}
    names = [new for new, _ in out.values()]
    if len(set(names)) != len(names):
        raise ValueError(f"two cells share a stand-in's name: {names}")
    return out


def tiny_cells(root: pathlib.Path = ROOT) -> list:
    """The stand-ins' names, in BENCHMARK.json's order."""
    return [new for new, _ in stand_ins(bench(root)).values()]


def tiny_copy(dst: pathlib.Path, src: pathlib.Path = ROOT) -> pathlib.Path:
    """A checkout of the benchmark alone (BENCHMARK.json and portbench/ of
    ``src``) in ``dst`` whose cells are ``src``'s at tiny sizes: each cell
    renamed to its stand-in (``stand_ins``), on its own traffic, with a
    tiny configuration."""
    shutil.copytree(src / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench(src)
    files = {c["name"]: src / c["file"] for c in b["configs"]}
    cells = stand_ins(b)
    configs = dict(TINY)
    for w in b["workloads"]:
        new, conf = cells[w["name"]]
        if conf not in configs:
            with open(files[w["config"]]) as f:
                g = json.load(f)["generator"]
            configs[conf] = {"generator": tiny_generator(g)}
        w["name"], w["config"] = new, conf
    b["configs"] = [{"name": k, "source": "tiny", "reduced": [],
                     "file": f"portbench/configs/{k}.json", "why": "tiny"}
                    for k in configs]
    for k, v in configs.items():
        (dst / "portbench" / "configs" / f"{k}.json").write_text(
            json.dumps(v))
    names = {old: new for old, (new, _) in cells.items()}
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
