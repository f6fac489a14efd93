"""The frozen generator: the copied bytes, the split into batch files, the
configurations' sizes, and the rewrites that make every job's input
new."""
import hashlib
import json

import numpy as np
import pytest

from benchtools import ROOT
from portbench import reference, workload

# sha256 of chip_smoke.write_workload(d, 42, 2000, 3, 0.01)'s files, the
# generator this one was copied from
COLL_SHA = "2ba01605aefd7a197a2abeb8684302ca9eb0017fb8738414d7bf8d20c4ab7fe0"
REF_SHA = "ded414c8cc4aafa4b700b8a5799c33362b47ce51b0572f2ca3d038118936c95d"


def sha(p):
    return hashlib.sha256(p.read_bytes()).hexdigest()


def config(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_copied_bytes(tmp_path):
    (coll,) = workload.write_workload(tmp_path, 42, 2000, 3, 0.01)
    assert sha(coll) == COLL_SHA
    assert sha(tmp_path / "ref.fa") == REF_SHA


@pytest.mark.parametrize("per", [1, 2, 3, 5])
def test_split_keeps_the_stream(tmp_path, per):
    (whole,) = workload.write_workload(tmp_path / "a", 7, 1500, 5, 0.01)
    parts = workload.write_workload(tmp_path / "b", 7, 1500, 5, 0.01,
                                    docs_per_file=per)
    assert len(parts) == -(-5 // per)
    assert b"".join(p.read_bytes() for p in parts) == whole.read_bytes()
    assert sha(tmp_path / "a" / "ref.fa") == sha(tmp_path / "b" / "ref.fa")


def test_full_sizes():
    e = workload.expected_files(config("ecoli100"))
    assert e == [(500_000_101, 508_334_090)]
    s = workload.expected_files(config("sars_cov2_10k"))
    assert s == [(299_040_001, 304_108_890)]
    for name, want in (("ecoli100", e), ("sars_cov2_10k", s)):
        assert config(name)["expected"] == {"sn": want[0][0],
                                            "file_bytes": want[0][1]}


@pytest.mark.parametrize("name,docs", [("ecoli100", 2),
                                       ("sars_cov2_10k", 30)])
def test_sizes_at_the_same_shapes(tmp_path, name, docs):
    """The configuration's reference length, rate and width with fewer
    documents: the files and SX are as expected_files works them out."""
    c = config(name)
    g = c["generator"]
    g["documents"] = docs
    ref, files = workload.make_inputs(c, 2**31 + 3, tmp_path)
    want = workload.expected_files(c)
    assert [f.stat().st_size for f in files] == [b for _, b in want]
    for f, (sn, _) in zip(files, want):
        sx = reference.collection_string(reference.read_file(f, "cpu"))
        assert sx.numel() == sn
        docs_here = (sn - 1) // (g["reference_bp"] + 1)
        assert int((sx == reference.SEPARATOR).sum()) == docs_here + 1


def test_same_seed_same_files(tmp_path):
    c = {"generator": {"reference_bp": 900, "documents": 4,
                       "substitution_rate": 0.01}}
    _, a = workload.make_inputs(c, 2**33 + 1, tmp_path / "a")
    _, b = workload.make_inputs(c, 2**33 + 1, tmp_path / "b")
    _, d = workload.make_inputs(c, 2**33 + 2, tmp_path / "d")
    assert a[0].read_bytes() == b[0].read_bytes() != d[0].read_bytes()


def test_substitution_draws(tmp_path):
    """Each document differs from the reference at no more than its draws'
    count of places, and at some."""
    c = {"generator": {"reference_bp": 29903, "documents": 6,
                       "substitution_rate": 0.002}}
    ref, (coll,) = workload.make_inputs(c, -5, tmp_path)
    r = np.frombuffer(b"".join(ref.read_bytes().split(b"\n")[1:]), np.uint8)
    docs = coll.read_bytes().split(b">")[1:]
    for d in docs:
        body = np.frombuffer(b"".join(d.split(b"\n")[1:]), np.uint8)
        diff = int(np.count_nonzero(body != r))
        assert 0 < diff <= int(29903 * 0.002)


def test_rewrites_and_rewind(tmp_path):
    """Each version differs from the one before in at most ``bases`` ACGT
    bytes a file, changed to other ACGT bytes; the lines, the size and
    SX's length stay; rewind takes the files back to any version."""
    c = {"generator": {"reference_bp": 3000, "documents": 5,
                       "substitution_rate": 0.01}}
    ref, (coll,) = workload.make_inputs(c, 2**40 + 7, tmp_path)
    rw = workload.Rewriter(2**40 + 7, bases=8, span=512)
    seen = [(ref.read_bytes(), coll.read_bytes())]
    for v in range(1, 7):
        assert rw.next([coll, ref]) == v == rw.version
        seen.append((ref.read_bytes(), coll.read_bytes()))
        for before, after in zip(seen[-2], seen[-1]):
            a = np.frombuffer(before, np.uint8)
            b = np.frombuffer(after, np.uint8)
            assert a.size == b.size
            diff = np.flatnonzero(a != b)
            assert 1 <= diff.size <= 8 and np.ptp(diff) < 512
            assert set(a[diff].tobytes()) <= set(b"ACGT")
            assert set(b[diff].tobytes()) <= set(b"ACGT")
        sx = reference.collection_string(reference.read_file(coll, "cpu"))
        assert sx.numel() == workload.expected_files(c)[0][0]
    assert len({s for s in seen}) == 7
    for v in (5, 2, 0):
        rw.rewind(v)
        assert rw.version == v
        assert (ref.read_bytes(), coll.read_bytes()) == seen[v]


def test_rewrites_follow_the_seed(tmp_path):
    c = {"generator": {"reference_bp": 2000, "documents": 3,
                       "substitution_rate": 0.01}}
    got = []
    for d, seed in (("a", 9), ("b", 9), ("c", 10)):
        _, (coll,) = workload.make_inputs(c, 9, tmp_path / d)
        rw = workload.Rewriter(seed)
        rw.next([coll])
        rw.next([coll])
        got.append(coll.read_bytes())
    assert got[0] == got[1] != got[2]
