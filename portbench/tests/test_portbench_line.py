"""The result's line of a run, driven on the CPU at tiny sizes: the tiny
stand-in of every cell of BENCHMARK.json (benchtools.stand_ins), read when
the tests are collected."""
import json

import pytest

import benchtools

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = benchtools.tiny_cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtools.tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(root, cell, capsys):
    line = benchtools.run_tiny(root, cell)
    assert list(line) == KEYS                 # checks come last
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    b = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in b["end_to_end"]
            if cell in m.get("workloads", [cell])}
    got = set(line["metrics"])
    # on the CPU there is no device peak to read
    assert got == want - {"peak_device_gib"} - (
        {"job_p95_ms"} if line["attempted"] < 20 else set())
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"mismatch_bytes", "wrong_sn_jobs",
                                   "failed_jobs"}
    for c in line["checks"].values():
        assert c == {"value": 0, "limit": 0}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-3:] == ["check mismatch_bytes 0 limit 0",
                        "check wrong_sn_jobs 0 limit 0",
                        "check failed_jobs 0 limit 0"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line(root, cell):
    line = benchtools.run_tiny(root, cell, trace=True)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10
    b = json.loads((root / "BENCHMARK.json").read_text())
    allowed = {m["name"] for m in b["per_layer"]
               if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= allowed
    assert "scan_ms" in line["metrics"]
    assert (root / "portbench_out" /
            f"trace-{cell}-{2**31 + 11}.json").exists()


def test_line_is_json(root):
    line = benchtools.run_tiny(root, "tiny_s")
    assert json.loads(json.dumps(line)) == line
