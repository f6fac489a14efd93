"""The port's span recorder (cmsbwt_tpu_torch/utils/timing.py) on the main
path: ``CMSBWT(...)``, its ``device_index`` and ``transform(path,
rle=True)`` on the jump route with the device merge, on the CPU. Under
torch.profiler every span of the main path is a ``cmsbwt.<name>``
annotation inside its parent; with the profiler off no
``record_function`` is entered; no span synchronises unless
CMSBWT_PROFILE is set, and then each prints its line; the counters agree
with what the call returns; the PhaseTimer's phases and report keep their
form."""
from __future__ import annotations

import json
import pathlib
import re
import threading

import numpy as np
import pytest
import torch

from helpers import make_fasta, mutate, random_dna
from cmsbwt_tpu_torch import CMSBWT
from cmsbwt_tpu_torch.io import output
from cmsbwt_tpu_torch.utils import timing

torch.set_num_threads(1)

# each span of the main path and the span it lies in (None: a root)
NESTING = {
    "index.load": None,
    "index.build": None,
    "index.sa": "index.build",
    "index.lcp": "index.build",
    "index.tail": "index.build",
    "transform": None,
    "parse.read": "transform",
    "parse.read.file": "parse.read",
    "parse.kernel": "transform",
    "ms_scan": "transform",
    "scan.tables": "ms_scan",
    "scan.kernel": "ms_scan",
    "scan.compact": "ms_scan",
    "merge_device": "transform",
    "merge.fixup": "merge_device",
    "merge.group": "merge_device",
    "merge.head_string_sa": "merge_device",
    "sa.round0": "merge.head_string_sa",
    "merge.rank_heads": "merge_device",
    "merge.tail_pairs_count": "merge_device",
    "merge.tail_good": "merge_device",
    "merge.tail_exact": "merge_device",
    "merge.runs_emit": "merge_device",
    "merge.counter": "merge_device",
    "encode": "transform",
    "encode.kernel": "encode",
    "encode.download": "encode",
    "encode.download.take": "encode.download",
}
# spans only a card's route has: the waits for a staged chunk's copy
CARD_ONLY = {"parse.read.wait": "parse.read",
             "encode.download.wait": "encode.download"}
MERGE_STAGES = [n for n, p in NESTING.items() if p == "merge_device"]
COUNTERS = ["parse.bytes", "sn", "parse.read.chunks", "parse.read.threads",
            "scan.attempts", "heads", "sa.comp_rounds", "sa.comp_rows",
            "sa.large_rows",
            "merge.tail_pairs", "merge.exact", "merge.runs",
            "encode.bytes", "encode.download.chunks", "encode.result.threads"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(25)
    ref = random_dna(rng, 700)
    (d / "ref.fa").write_bytes(make_fasta([ref]))
    (d / "coll.fa").write_bytes(make_fasta(
        [mutate(rng, ref, 0.02) for _ in range(4)]))
    return d / "ref.fa", d / "coll.fa"


def job(files):
    """The benchmark's job: the index built, then one transform."""
    ref, coll = files
    timing.reset()
    model = CMSBWT(str(ref), device="cpu")
    model.device_index
    return model.transform(str(coll), rle=True, backend="jump")


@pytest.fixture(scope="module")
def traced(files, tmp_path_factory):
    """The job under torch.profiler: the program's annotations."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        job(files)
    path = tmp_path_factory.mktemp("trace") / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e["name"][len("cmsbwt."):]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith("cmsbwt.")]


@pytest.mark.parametrize("name", sorted(NESTING))
def test_every_span_is_annotated_inside_its_parent(traced, name):
    mine = [(t0, t1) for t0, t1, n in traced if n == name]
    assert mine, f"no cmsbwt.{name} annotation"
    parent = NESTING[name]
    if parent is None:
        return
    outer = [(t0, t1) for t0, t1, n in traced if n == parent]
    for t0, t1 in mine:
        assert any(p0 <= t0 and t1 <= p1 for p0, p1 in outer), \
            f"cmsbwt.{name} at {t0} lies outside cmsbwt.{parent}"


def test_only_the_table_spans_on_the_cpu_route(traced):
    names = {n for _, _, n in traced}
    assert names == set(NESTING)
    assert not names & set(CARD_ONLY)


def test_annotations_match_the_span_table(files, traced):
    job(files)
    calls = {}
    for _, _, n in traced:
        calls[n] = calls.get(n, 0) + 1
    assert {n: c for n, (_, c) in timing.SPANS.items()} == calls


def test_spans_under_the_profiler_go_to_the_trace_alone():
    """A span run while the profiler records is left out of the table (its
    time carries the profiler's cost); counts and phases are kept."""
    from torch.profiler import ProfilerActivity, profile
    timing.reset()
    timer = timing.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.phase("traced"):
            timing.count("traced.n", 1)
    with timing.span("plain"):
        pass
    assert set(timing.SPANS) == {"plain"}
    assert dict(timing.COUNTS) == {"traced.n": 1}
    assert [n for n, _ in timer.phases] == ["traced"]

def test_no_record_function_while_the_profiler_is_off(files, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler "
                             "off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res = job(files)
    assert res.rle
    assert set(timing.SPANS) == set(NESTING)


def test_no_span_synchronises_without_cmsbwt_profile(files, monkeypatch):
    monkeypatch.delenv("CMSBWT_PROFILE", raising=False)
    syncs = []
    monkeypatch.setattr(timing, "_sync", lambda: syncs.append(1))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(2))
    job(files)
    assert syncs == []
    # CMSBWT_PROFILE: one synchronise at each span's end
    monkeypatch.setenv("CMSBWT_PROFILE", "1")
    job(files)
    assert syncs.count(1) == sum(c for _, c in timing.SPANS.values())
    assert 2 not in syncs


@pytest.mark.parametrize("stage", MERGE_STAGES)
def test_cmsbwt_profile_prints_each_merge_stage(files, monkeypatch, capsys,
                                                stage):
    monkeypatch.setenv("CMSBWT_PROFILE", "1")
    job(files)
    err = capsys.readouterr().err
    lines = re.findall(rf"^#   {re.escape(stage)}: ([0-9.]+) ms$", err,
                       re.MULTILINE)
    assert len(lines) == 1


@pytest.mark.parametrize("name", COUNTERS)
def test_cmsbwt_profile_prints_each_counter(files, monkeypatch, capsys,
                                            name):
    """Under CMSBWT_PROFILE a count prints its size beside the spans'
    lines: what the stage marks' strings printed (P, exact, R, h)."""
    monkeypatch.setenv("CMSBWT_PROFILE", "1")
    job(files)
    err = capsys.readouterr().err
    got = re.findall(rf"^#   {re.escape(name)}: (\d+)$", err, re.MULTILINE)
    assert got and sum(int(v) for v in got) == timing.COUNTS[name]


def test_counts_print_nothing_without_cmsbwt_profile(monkeypatch, capsys):
    monkeypatch.delenv("CMSBWT_PROFILE", raising=False)
    timing.reset()
    timing.count("merge.runs", 7)
    assert capsys.readouterr().err == ""
    assert timing.COUNTS["merge.runs"] == 7


def test_a_timer_makes_each_scan_stage_one_span(files, tmp_path):
    """The CLI's route (compute_bwt) times the jump scan as the model
    does: one phase ``ms_scan`` whose seconds cover the spans
    scan.tables, scan.kernel and scan.compact, each recorded once; the
    stages are no phases of their own."""
    from cmsbwt_tpu_torch.config import Config
    from cmsbwt_tpu_torch.engine.pipeline import compute_bwt
    lst = tmp_path / "input.txt"
    lst.write_text(f"{files[0]}\n{files[1]}\n")
    timing.reset()
    out = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                             backend="jump", lanes=8), "cpu")
    phases = out["timer"].phases
    assert [n for n, _ in phases] == [
        "load_reference", "parse_collection", "build_index", "ms_scan",
        "merge_device", "write_output"]
    scan = dict(phases)["ms_scan"]
    assert timing.SPANS["ms_scan"] == [scan, 1]
    stages = ["scan.tables", "scan.kernel", "scan.compact"]
    for sub in stages:
        assert timing.SPANS[sub][1] == 1
    assert sum(timing.SPANS[sub][0] for sub in stages) <= scan
    assert timing.COUNTS["heads"] == out["result"].h


def test_counters_agree_with_the_call(files):
    res = job(files)
    c = dict(timing.COUNTS)
    assert sorted(c) == sorted(COUNTERS)
    assert c["heads"] == res.heads
    assert c["sn"] == res.sn
    assert c["merge.runs"] == output.LAST_WRITE["runs"]
    assert c["encode.bytes"] == len(res.rle) == output.LAST_WRITE["bytes"]
    assert c["parse.bytes"] == pathlib.Path(files[1]).stat().st_size
    assert c["scan.attempts"] >= 1
    assert c["parse.read.chunks"] == c["encode.download.chunks"] == 1
    # the CPU route reads the file on the calling thread
    assert c["parse.read.threads"] == 1
    # one thread copies a result smaller than a huge page
    assert c["encode.result.threads"] == 1
    assert 0 <= c["merge.exact"] <= c["merge.tail_pairs"]


def test_phase_timer_keeps_its_phases_and_report(files):
    res = job(files)
    assert [n for n, _ in res.timer.phases] == ["ms_scan", "merge_device",
                                                "encode"]
    lines = res.timer.report().splitlines()
    assert [ln.split(": ")[0] for ln in lines] == [
        "ms_scan", "merge_device", "encode", "total"]
    assert all(re.fullmatch(r"[a-z_]+: \d+\.\d ms", ln) for ln in lines)
    for n, s in res.timer.phases:
        assert timing.SPANS[n] == [s, 1]


def test_phase_timer_appends_on_error():
    t = timing.PhaseTimer()
    with pytest.raises(ValueError):
        with t.phase("a"):
            raise ValueError
    assert [n for n, _ in t.phases] == ["a"]
    assert t.report().startswith("a: ")


def test_tables_are_per_thread_and_reset():
    timing.reset()
    with timing.span("main"):
        timing.count("main.n", 2)
    seen = {}

    def other():
        seen["before"] = dict(timing.SPANS)
        with timing.span("other"):
            timing.count("other.n", 1)
        seen["after"] = (set(timing.SPANS), dict(timing.COUNTS))
    th = threading.Thread(target=other)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert seen == {"before": {}, "after": ({"other"}, {"other.n": 1})}
    assert set(timing.SPANS) == {"main"}
    assert dict(timing.COUNTS) == {"main.n": 2}
    timing.count("main.n", 3)
    assert timing.COUNTS["main.n"] == 5
    timing.reset()
    assert not timing.SPANS and not timing.COUNTS


def test_the_old_exporters_are_gone():
    assert not hasattr(timing, "stage_timer")
    assert not hasattr(timing, "maybe_torch_trace")
    root = pathlib.Path(timing.__file__).resolve().parents[1]
    for p in root.rglob("*.py"):
        text = p.read_text()
        assert "CMSBWT_TRACE_DIR" not in text, p
        assert not re.search(r"\bstage_timer\b", text), p


DENSE = ["build_joint", "joint_sa", "irreducible", "lift", "fill_ell",
         "neighbors", "assemble"]


@pytest.mark.parametrize("route,want", [
    ("unblocked", {"dense." + s for s in DENSE + [
        "postprocess", "compact", "finish"]}),
    ("blocked", {"dense.block." + s for s in DENSE + ["load", "sep", "put",
                                                      "post"]}
     | {"dense.block", "dense.concat_blocks", "dense.finish_for_merge"}),
])
def test_dense_routes_record_their_stages(files, route, want, monkeypatch,
                                          capsys):
    """The dense scans' former stage marks are spans: recorded, and under
    CMSBWT_PROFILE printed one line each."""
    from cmsbwt_tpu_torch.io import fasta
    from cmsbwt_tpu_torch.ops import ms_dense
    x = fasta.augment_reference(fasta.load_reference_bytes(str(files[0])))
    sx = fasta.parse_collection(str(files[1]), 1 << 60).sx
    monkeypatch.setenv("CMSBWT_PROFILE", "1")
    timing.reset()
    if route == "unblocked":
        res = ms_dense.ms_dense_heads_on_device(x, sx, "cpu")
    else:
        res = ms_dense.ms_dense_heads_blocked_on_device(
            x, sx, "cpu", block_chars=len(sx) // 3 + 1)
        assert timing.COUNTS["dense.blocks"] == 3
    assert set(timing.SPANS) == want
    assert timing.COUNTS["heads"] == res.h
    assert timing.COUNTS["dense.rho"] == res.irreducible
    err = capsys.readouterr().err
    assert len(re.findall(r"^#   dense\.[a-z_.]+: [0-9.]+ ms$", err,
                          re.MULTILINE)) == \
        sum(c for _, c in timing.SPANS.values())
