"""The cell sars10k_nrun_r (sars_cov2_10k with one run of N a genome) and
the readers of the head string's sort, head_sa_ms and sa_large_rows: on a
made table of the program's spans and counters, on a program without
them (None, and no exception), and in the cell's tiny stand-in, run on the
CPU through the jump route and the device merge."""
import json
import pathlib

import pytest

import benchtools
from benchtools import ROOT
from cmsbwt_tpu_torch.utils import timing
from portbench import guard, harness, workload

READERS = ["head_sa_ms", "sa_large_rows"]
CELL = "sars10k_nrun_r"


def made_run(traced: int = 2, untraced: int = 4):
    job = dict(input=0, wall_s=0.1, sn=1000, file_bytes=1100, phases={},
               read_s=0.02, runs=10, rle=True, index_s=None, out_len=90,
               version=1, cpu_s=0.1, minflt=0)
    return harness.Run(traffic={}, config={}, setup_s=1.0, window_s=1.0,
                       jobs=[harness.Job(traced=i < traced, **job)
                             for i in range(traced + untraced)],
                       launches={}, peak_bytes=None, trace=None,
                       skip_window=64)


def read(name, run):
    return harness.reader(ROOT, name)(run)


@pytest.fixture(autouse=True)
def clean_table():
    timing.reset()
    yield
    timing.reset()


def fill_table(calls: int, spans_ms: dict, counts: dict) -> None:
    """The program's table after ``calls`` transforms outside the profiler,
    each with ``spans_ms``, and its counters as given (whole, traced calls
    among them)."""
    table = timing.SPANS
    table["transform"] = [0.5 * calls, calls]
    for n, ms in spans_ms.items():
        table[n] = [ms * 1e-3 * calls, calls]
    timing.COUNTS.update(counts)


def test_head_sa_ms_sums_the_three_spans_a_job():
    fill_table(5, {"sa.round0": 2.0, "sa.comp": 7.0, "sa.tail": 1.0,
                   "merge_device": 80.0}, {})
    assert read("head_sa_ms", made_run()) == pytest.approx(10.0)


def test_sa_large_rows_counts_every_call():
    """The counter holds the traced calls too: 5 outside the profiler and
    the run's 2 traced jobs."""
    fill_table(5, {"sa.round0": 1.0}, {"sa.large_rows": 7 * 15_000_000,
                                       "sa.comp_rows": 7 * 16_000_000})
    assert read("sa_large_rows", made_run(traced=2)) == pytest.approx(
        15_000_000)
    # a run with no job traced: the table's calls alone
    timing.reset()
    fill_table(5, {"sa.round0": 1.0}, {"sa.large_rows": 0})
    assert read("sa_large_rows", made_run(traced=0)) == 0


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_names_gives_nothing(name):
    """An older program has the table but none of these names."""
    fill_table(5, {"merge.head_string_sa": 12.0, "merge_device": 80.0},
               {"heads": 5_500_000, "merge.runs": 10})
    assert read(name, made_run()) is None
    timing.reset()
    assert read(name, made_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_table_gives_nothing(name, monkeypatch):
    monkeypatch.delattr(timing, "__getattr__")
    assert not hasattr(timing, "SPANS") and not hasattr(timing, "COUNTS")
    assert read(name, made_run()) is None


def test_the_cell_and_its_configuration():
    b = benchtools.bench()
    cell = {w["name"]: w for w in b["workloads"]}[CELL]
    assert cell == {**cell, "config": "sars_cov2_10k_nrun",
                    "traffic": "held_index_r", "chips": 1}
    conf = {c["name"]: c for c in b["configs"]}["sars_cov2_10k_nrun"]
    assert conf["reduced"] == []
    with open(ROOT / conf["file"]) as f:
        c = json.load(f)
    with open(ROOT / "portbench" / "configs" / "sars_cov2_10k.json") as f:
        base = json.load(f)
    # sars_cov2_10k's generator word for word, and one run of 250 N
    assert c["generator"] == {**base["generator"], "n_run": 250}
    # N overwrites bases: sn and the file's bytes are sars_cov2_10k's
    assert workload.expected_files(c) == [(c["expected"]["sn"],
                                           c["expected"]["file_bytes"])]
    assert c["expected"] == base["expected"]
    metrics = {m["name"]: m for m in b["per_layer"]}
    for name in READERS:
        assert metrics[name]["moves"] == "chars_per_s"
        assert metrics[name]["workloads"] == ["ecoli100_r", "sars10k_r",
                                              CELL]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtools.tiny_copy(tmp_path_factory.mktemp("bench"))


def stand_in(root) -> str:
    new, conf = benchtools.stand_ins(benchtools.bench())[CELL]
    assert new == "tiny_" + CELL
    with open(root / "portbench" / "configs" / f"{conf}.json") as f:
        assert json.load(f)["generator"]["n_run"] == 250
    return new


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_the_stand_in_runs_correct(root, trace):
    line = benchtools.run_tiny(root, stand_in(root), seed=2**31 + 7,
                               trace=trace)
    assert line["correct"] is True, line
    assert line["failed"] == 0


def test_the_stand_in_on_the_jump_route_reports_the_readers(root):
    """The cells' route on a card (the jump scan, the device merge, whose
    head string sort holds the spans): both readers report; 12 documents
    keep the N group below COMP_CAP."""
    guard.install()
    line = harness.run_cell(pathlib.Path(root), stand_in(root), 2**31 + 7,
                            0.5, True, device="cpu",
                            program={"backend": "jump"})
    assert line["correct"] is True, line
    m = line["metrics"]
    assert m["head_sa_ms"]["value"] > 0
    assert m["sa_large_rows"]["value"] == 0
