"""Collections with runs of N, as amplicon dropouts leave them in
surveillance genomes, through the port's main path on the CPU:
``CMSBWT.transform`` with the jump scan and the device merge, on files
written by the benchmark's generator (portbench.workload.write_workload,
one run of ``n_run`` N a document).

N is not in the reference, so every N byte is a phrase of length 1: a
head, all of them in one class with one rank, so that the head string
holds one run of equal ranks a document. Its suffix sort
(index/device._suffix_array_starts) then carries one group of every
suffix that starts with two N from round to round. With 24 documents the
group holds about 6 000 rows at the first compacted round, above
COMP_CAP, and takes the large-group path; with 12 it stays below.

Checked: the .bwt and the .rl_bwt byte for byte against the C++ reference
tool (baseline/cms-bwt-ref, whose -r output carries the RLE quirk, so the
port's quirk is on there) and against the benchmark's plain reference
(portbench.reference, quirk off); the head count with one head a N; the
head string's spans (``sa.round0``, ``sa.comp``, ``sa.tail``) nested under
``merge.head_string_sa``, and its counters (``sa.comp_rounds``,
``sa.comp_rows``, ``sa.large_rows``)."""
from __future__ import annotations

import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from cmsbwt_tpu_torch import CMSBWT
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.index.device import COMP_CAP
from cmsbwt_tpu_torch.io import fasta
from cmsbwt_tpu_torch.ops.ms_jump import ms_jump_heads
from cmsbwt_tpu_torch.utils import timing
from portbench import reference, workload

torch.set_num_threads(1)

REF_BIN = pathlib.Path(__file__).resolve().parents[1] / "baseline" / \
    "cms-bwt-ref"
LANES = 64
# (reference bp, documents, n_run): the N group above and below COMP_CAP
CASES = {"above_cap": (3000, 24, 250), "below_cap": (3000, 12, 250)}
SEED = 2**31 + 7


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """The case's files, the tool's two outputs and the plain reference's,
    and the port's transforms (keyed by quirk, rle) with the table and
    counters of the quirk-off .rl_bwt transform."""
    name = request.param
    ref_bp, docs, n_run = CASES[name]
    d = tmp_path_factory.mktemp(name)
    (coll,) = workload.write_workload(d, SEED, ref_bp, docs, 0.002,
                                      n_run=n_run)
    lst = d / "list.txt"
    lst.write_text(f"{d / 'ref.fa'}\n{coll}\n")
    tool = {}
    for rle in (False, True):
        out = d / ("tool_r" if rle else "tool")
        subprocess.run([str(REF_BIN), *(["-r"] if rle else []), "-o",
                        str(out), str(lst)], check=True, capture_output=True)
        tool[rle] = out.with_suffix(".rl_bwt" if rle else ".bwt") \
            .read_bytes()
    cpu = torch.device("cpu")
    plain = {rle: reference.output_of_file(coll, cpu, rle)[1]
             for rle in (False, True)}
    got, table = {}, None
    # the quirk changes only the .rl_bwt
    for quirk, rle in ((True, False), (True, True), (False, True)):
        model = CMSBWT(str(d / "ref.fa"), Config(
            lanes=LANES, replicate_reference_rle_quirk=quirk), "cpu")
        timing.reset()
        got[quirk, rle] = model.transform(str(coll), rle=rle,
                                          backend="jump")
        if not quirk:
            table = (dict(timing.SPANS), dict(timing.COUNTS))
    got[False, False] = got[True, False]
    return {"name": name, "dir": d, "coll": coll, "tool": tool,
            "plain": plain, "got": got, "table": table}


@pytest.mark.parametrize("rle", [False, True], ids=["bwt", "rl_bwt"])
def test_bytes_equal_the_tool(case, rle):
    res = case["got"][True, rle]
    assert (res.rle if rle else res.bwt) == case["tool"][rle]


@pytest.mark.parametrize("rle", [False, True], ids=["bwt", "rl_bwt"])
def test_bytes_equal_the_plain_reference(case, rle):
    res = case["got"][False, rle]
    out = res.rle if rle else res.bwt
    assert reference.mismatch_bytes(out, case["plain"][rle]) == 0
    assert out == case["plain"][rle]


def test_one_head_a_n(case):
    """Every N of SX is a head of length 1, and the transform counts the
    scan's heads."""
    x = fasta.augment_reference(fasta.load_reference_bytes(
        str(case["dir"] / "ref.fa")))
    sx = fasta.parse_collection(str(case["coll"]), 1 << 60).sx
    res = ms_jump_heads(x, sx, "cpu", lanes=LANES)
    h = res.h
    t, ln = res.head_t[:h].numpy(), res.head_len[:h].numpy()
    n_at = np.flatnonzero(sx == ord("N"))
    _, docs, n_run = CASES[case["name"]]
    assert n_at.size == docs * n_run
    assert np.isin(n_at, t[ln == 1]).all()
    assert case["got"][False, True].heads == h
    assert case["table"][1]["heads"] == h


def test_large_group_path_taken_above_the_cap(case):
    _, counts = case["table"]
    large = counts["sa.large_rows"]
    if case["name"] == "above_cap":
        # the N group's rows at round 1, and in the rounds after it
        assert large > COMP_CAP
    else:
        assert large == 0
    assert 0 <= large <= counts["sa.comp_rows"]
    assert counts["sa.comp_rounds"] >= 1


def test_head_string_spans(case):
    spans, counts = case["table"]
    for name in ("sa.comp_rounds", "sa.comp_rows", "sa.large_rows"):
        assert name in counts
    assert spans["sa.round0"][1] == 1
    assert spans["sa.tail"][1] == 1
    if case["name"] == "above_cap":
        # one span a compacted round before the tail, which runs the rest
        assert spans["sa.comp"][1] >= 1
        assert spans["sa.comp"][1] + 1 <= counts["sa.comp_rounds"]
    else:
        assert "sa.comp" not in spans


def test_head_string_spans_nest_under_the_merge(case, tmp_path):
    """Under torch.profiler the spans are annotations inside
    merge.head_string_sa."""
    from torch.profiler import ProfilerActivity, profile
    model = CMSBWT(str(case["dir"] / "ref.fa"), Config(
        lanes=LANES, replicate_reference_rle_quirk=False), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.transform(str(case["coll"]), rle=True, backend="jump")
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
               e["name"][len("cmsbwt."):])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("cmsbwt.")]
    outer = [(t0, t1) for t0, t1, n in events
             if n == "merge.head_string_sa"]
    assert len(outer) == 1
    want = {"sa.round0", "sa.tail"} | (
        {"sa.comp"} if case["name"] == "above_cap" else set())
    assert {n for _, _, n in events if n.startswith("sa.")} == want
    for t0, t1, n in events:
        if n.startswith("sa."):
            assert outer[0][0] <= t0 and t1 <= outer[0][1], n
