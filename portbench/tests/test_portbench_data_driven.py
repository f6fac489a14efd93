"""A cell, a configuration, a traffic mix and a metric added as new files
(and entries in BENCHMARK.json) in a copy are found without an edit to
any file of the benchmark."""
import hashlib
import json

import benchtools


def digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_files_are_found(tmp_path):
    root = benchtools.tiny_copy(tmp_path)
    before = digests(root)
    pb = root / "portbench"
    (pb / "configs" / "tiny_new.json").write_text(json.dumps(
        {"generator": {"reference_bp": 1500, "documents": 5,
                       "documents_per_file": 2, "substitution_rate": 0.02,
                       "line_width": 0}}))
    (pb / "traffic" / "plain_held.json").write_text(json.dumps(
        {"output": "bwt", "index": "held", "trace_jobs": 2,
         "check_jobs": 1, "program": {}}))
    (pb / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny_new", "source": "tiny",
                         "file": "portbench/configs/tiny_new.json",
                         "reduced": [], "why": "tiny"})
    b["workloads"].append({"name": "tiny_new_plain", "config": "tiny_new",
                           "traffic": "plain_held", "chips": 1,
                           "why": "tiny"})
    b["per_layer"].append({"name": "jobs_done", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "chars_per_s",
                           "workloads": ["tiny_new_plain"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    assert {k: v for k, v in digests(root).items() if k in before} == before
    line = benchtools.run_tiny(root, "tiny_new_plain", trace=True)
    assert line["correct"] is True
    assert line["metrics"]["jobs_done"]["value"] >= 2
    # metrics without a "workloads" key reach the new cell too
    line = benchtools.run_tiny(root, "tiny_new_plain")
    assert "chars_per_s" in line["metrics"]
    assert "job_p95_ms" not in line["metrics"]
