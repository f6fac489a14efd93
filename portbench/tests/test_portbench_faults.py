"""The check that decides ``correct``, shown to fail: each fault a cell
can have, planted under the timed path of the tiny stand-in of every cell
on the CPU, and the control (portbench/control.py: the program's own
RLE-quirk path, which breaks the configuration's exact .rl_bwt; for a
.bwt, the reference with its separators out of document order), all come
out not correct. (One chip: no exchange between chips to leave out.)
Every job reads a new version of its files, so a program that hands back
an answer it kept, by path or from the job before, is caught."""
import dataclasses
import json

import pytest

import benchtools
from cmsbwt_tpu_torch.models.cms_bwt import CMSBWT
from portbench import control

CELLS = benchtools.tiny_cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return benchtools.tiny_copy(tmp_path_factory.mktemp("bench"))


def stale(orig):
    """A job that hands back the previous job's answer, its state never
    moved on."""
    last = {}

    def transform(self, collection, rle=False, backend=None):
        r = orig(self, collection, rle=rle, backend=backend)
        out = last.get("r", r)
        last["r"] = r
        return out
    return transform


def half(orig):
    """Half of the batch left out: the first half of the documents
    transformed, the rest dropped."""
    def transform(self, collection, rle=False, backend=None):
        with open(collection, "rb") as f:
            docs = f.read().split(b"\n>")
        keep = b"\n>".join(docs[:max(1, len(docs) // 2)]) + b"\n"
        cut = collection + ".half"
        with open(cut, "wb") as f:
            f.write(keep)
        return orig(self, cut, rle=rle, backend=backend)
    return transform


def by_path(orig):
    """The answers kept by the collection's path: a file read once."""
    kept = {}

    def transform(self, collection, rle=False, backend=None):
        key = (collection, rle)
        if key not in kept:
            kept[key] = orig(self, collection, rle=rle, backend=backend)
        return kept[key]
    return transform


def altered(orig):
    """One byte of the answer altered where it is produced."""
    def transform(self, collection, rle=False, backend=None):
        r = orig(self, collection, rle=rle, backend=backend)
        key = "rle" if rle else "bwt"
        b = bytearray(getattr(r, key))
        b[len(b) // 2] ^= 0x01
        return dataclasses.replace(r, **{key: bytes(b)})
    return transform


@pytest.mark.parametrize("fault", [stale, half, altered, by_path])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    monkeypatch.setattr(CMSBWT, "transform", fault(CMSBWT.transform))
    line = benchtools.run_tiny(root, cell, seconds=0.3)
    assert line["correct"] is False
    assert line["failed"] >= 1
    assert line["checks"]["mismatch_bytes"]["value"] > 0 or \
        line["checks"]["wrong_sn_jobs"]["value"] > 0


@pytest.mark.parametrize("cell,traffic", [("tiny_e", "per_job_index_r"),
                                          ("tiny_s", "held_index_r")])
def test_control_is_not_correct(root, cell, traffic):
    """The control: the program with its RLE-quirk path switched on."""
    path = root / "portbench" / "traffic" / f"{traffic}.json"
    saved = path.read_text()
    t = json.loads(saved)
    t["program"]["replicate_reference_rle_quirk"] = True
    path.write_text(json.dumps(t))
    try:
        line = benchtools.run_tiny(root, cell, seconds=0.3)
    finally:
        path.write_text(saved)
    assert line["correct"] is False
    assert line["checks"]["mismatch_bytes"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_a_control_that_fails(root, cell):
    """The control control.py runs for the cell, in the program's place."""
    line = control.run(root, cell, 2**31 + 13, 0.3, device="cpu")
    assert line["correct"] is False
    assert line["checks"]["mismatch_bytes"]["value"] > 0


def test_unordered_separators_change_the_bwt():
    """The .bwt control's sort differs from the reference's on the first
    row: there the reference's BWT holds SX's last separator, the control's
    a document's last byte."""
    import torch
    from portbench import reference
    sx = torch.frombuffer(bytearray(b"\x02ACGT\x02ACGA\x02"),
                          dtype=torch.uint8)
    want = reference.bwt(sx)
    got = control.unordered_bwt(sx)
    assert sorted(got.tolist()) == sorted(want.tolist())
    assert int(want[0]) == reference.SEPARATOR != int(got[0])
