"""The tiny stand-ins of the benchmark's cells (test_portbench_line runs
every one of them): the first cells keep theirs, and a cell added with its
files alone gets one by the stated rule (benchtools.tiny_generator), with
no edit to the tests."""
import json
import shutil

import pytest

import benchtools
from benchtools import ROOT


def test_stand_ins_keep_the_first_cells():
    b = benchtools.bench()
    got = benchtools.stand_ins(b)
    assert got["ecoli100_r"] == ("tiny_e", "tiny_one")
    assert got["sars10k_r"] == ("tiny_s", "tiny_batches")
    for w in b["workloads"]:
        if w["name"] not in benchtools.CELLS:
            assert got[w["name"]] == ("tiny_" + w["name"],
                                      "tiny_" + w["config"])


@pytest.mark.parametrize("g,want", [
    ({"reference_bp": 5000000, "documents": 100, "substitution_rate": 0.01,
      "line_width": 60},
     {"reference_bp": 3000, "documents": 12, "substitution_rate": 0.01,
      "line_width": 60}),
    ({"reference_bp": 29903, "documents": 10000, "documents_per_file": 2000,
      "substitution_rate": 0.002, "n_run": 250, "line_width": 0},
     {"reference_bp": 3000, "documents": 12, "documents_per_file": 4,
      "substitution_rate": 0.002, "n_run": 250, "line_width": 0}),
    # small sizes kept; the N run at most an eighth of the reference
    ({"reference_bp": 1200, "documents": 5, "documents_per_file": 2,
      "substitution_rate": 0.03, "n_run": 400},
     {"reference_bp": 1200, "documents": 5, "documents_per_file": 2,
      "substitution_rate": 0.03, "n_run": 150}),
    ({"reference_bp": 4, "documents": 3, "substitution_rate": 0.0,
      "n_run": 3},
     {"reference_bp": 4, "documents": 3, "substitution_rate": 0.0,
      "n_run": 1}),
    ({"reference_bp": 9000, "documents": 40, "substitution_rate": 0.01,
      "n_run": 0},
     {"reference_bp": 3000, "documents": 12, "substitution_rate": 0.01,
      "n_run": 0}),
])
def test_tiny_generator(g, want):
    assert benchtools.tiny_generator(g) == want


def test_long_names_are_cut():
    assert benchtools.tiny("x" * 64) == "tiny_" + "x" * 59
    with pytest.raises(ValueError, match="stand-in"):
        benchtools.stand_ins({"workloads": [
            {"name": "a" * 60 + "1", "config": "c"},
            {"name": "a" * 60 + "2", "config": "c"}]})


def test_a_new_cell_needs_no_edit(tmp_path):
    """A scratch repository whose BENCHMARK.json has one more cell, on a
    new configuration with batch files and an N run: its stand-in is
    derived, listed in the metrics' cells, and runs correct."""
    src = tmp_path / "src"
    shutil.copytree(ROOT / "portbench", src / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (src / "portbench" / "configs" / "sars_nrun.json").write_text(json.dumps(
        {"generator": {"reference_bp": 29903, "documents": 10000,
                       "documents_per_file": 2000, "n_run": 250,
                       "substitution_rate": 0.002, "line_width": 60}}))
    b = benchtools.bench()
    b["configs"].append({"name": "sars_nrun", "source": "scratch",
                         "file": "portbench/configs/sars_nrun.json",
                         "reduced": [], "why": "scratch"})
    b["workloads"].append({"name": "sars_nrun_r", "config": "sars_nrun",
                           "traffic": "held_index_r", "chips": 1,
                           "why": "scratch"})
    for m in b["per_layer"]:
        if "sars10k_r" in m.get("workloads", []):
            m["workloads"].append("sars_nrun_r")
    (src / "BENCHMARK.json").write_text(json.dumps(b))

    root = benchtools.tiny_copy(tmp_path / "dst", src)
    assert benchtools.tiny_cells(src)[-1] == "tiny_sars_nrun_r"
    got = json.loads((root / "BENCHMARK.json").read_text())
    assert {"name": "tiny_sars_nrun_r", "config": "tiny_sars_nrun",
            "traffic": "held_index_r", "chips": 1,
            "why": "scratch"} in got["workloads"]
    assert all("tiny_sars_nrun_r" in m["workloads"] for m in got["per_layer"]
               if "tiny_s" in m.get("workloads", []))
    conf = json.loads((root / "portbench" / "configs" /
                       "tiny_sars_nrun.json").read_text())
    assert conf == {"generator": {
        "reference_bp": 3000, "documents": 12, "documents_per_file": 4,
        "n_run": 250, "substitution_rate": 0.002, "line_width": 60}}
    for trace in (False, True):
        line = benchtools.run_tiny(root, "tiny_sars_nrun_r", trace=trace)
        assert line["correct"] is True, line
