"""ops/ms_device.ms_scan_device (the jump scan's heads expanded to every
position) against the JAX package's ms_scan_device field by field, on the
cases of tests/test_ms_device.py (chunk boundaries everywhere, one lane
and many, documents of chars absent from the reference), and against the
host spec scan. Tolerance: exact equality, dtypes included."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers import make_fasta, mutate, random_dna
from torch_cases import CASE_IDS, CASES, assert_same, case_collection
from cmsbwt_tpu.index import device as JD
from cmsbwt_tpu.io import fasta as jfasta
from cmsbwt_tpu.ops.ms_device import ms_scan_device as jax_ms_scan_device
from cmsbwt_tpu_torch.config import SEPARATOR
from cmsbwt_tpu_torch.engine.ms_host import ms_scan_collection
from cmsbwt_tpu_torch.index.device import build_device_index
from cmsbwt_tpu_torch.index.host import build_reference_index
from cmsbwt_tpu_torch.ops.ms_device import expand_heads, ms_scan_device

torch.set_num_threads(1)

FIELDS = ("pos", "length", "smaller", "is_head")


def _collection(tmp_path, ref, docs):
    p = tmp_path / "c.fa"
    p.write_bytes(make_fasta(docs))
    coll = jfasta.parse_collection(str(p), 1 << 60)
    return np.frombuffer(jfasta.augment_reference(ref), np.uint8), coll.sx


def _check(x, sx, lanes, window):
    """The port against JAX's ms_scan_device and the host spec scan."""
    want = jax_ms_scan_device(JD.build_device_index(x), sx, lanes=lanes,
                              window=window)
    got = ms_scan_device(build_device_index(x, "cpu"), sx, "cpu",
                         lanes=lanes, window=window)
    for f in FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)
    spec = ms_scan_collection(build_reference_index(x), sx,
                              np.nonzero(sx == SEPARATOR)[0])
    for f in ("pos", "length", "is_head"):
        assert_same(getattr(spec, f), getattr(got, f), "spec " + f)
    assert_same(spec.smaller & spec.is_head, got.smaller, "spec smaller")
    return got


@pytest.mark.parametrize("seed,reflen,ndocs,snp,lanes", [
    (0, 300, 3, 0.02, 4),
    (1, 800, 5, 0.005, 16),
    (2, 500, 4, 0.05, 7),    # odd lane count, chunk boundaries everywhere
    (3, 200, 2, 0.0, 3),     # exact copies: long matches, deep skip bursts
])
def test_ms_scan_device_matches_jax(tmp_path, seed, reflen, ndocs, snp,
                                    lanes):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, reflen)
    docs = [mutate(rng, ref, snp) for _ in range(ndocs)]
    _check(*_collection(tmp_path, ref, docs), lanes, 32)


@pytest.mark.parametrize("lanes", [1, 64])
def test_ms_scan_device_absent_chars(tmp_path, lanes):
    """tests/test_ms_device.py's b"ACGTNNN" document (N is not in the
    reference), and one of several chars absent from it."""
    rng = np.random.default_rng(4)
    ref = random_dna(rng, 400)
    docs = [mutate(rng, ref, 0.01), b"ACGTNNN", mutate(rng, ref, 0.01),
            b"NNXYZWWQNN"]
    _check(*_collection(tmp_path, ref, docs), lanes, 16)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_ms_scan_device_on_torch_cases(case):
    x, sx = case_collection(case)
    _check(x, sx, 64, 64)


def test_separator_after_a_match_at_the_reference_end(tmp_path):
    """Documents whose last chars match at the end of the reference text
    (pos len(ref) - 1) and at the augmented reference's last appended char
    (byte 127 at pos n - 3): the separator after each (pos n - 1, len 0)
    is a head, and so is the next document's start."""
    rng = np.random.default_rng(9)
    ref = random_dna(rng, 300)
    docs = [ref[-40:], ref[-1:], ref[-2:] + b"\x7f", ref, b"\x7f"]
    x, sx = _collection(tmp_path, ref, docs)
    got = _check(x, sx, 5, 16)
    n = len(x)
    assert x[n - 3] == 127
    sep = np.nonzero(sx == SEPARATOR)[0]
    assert got.is_head[sep].all() and (got.pos[sep] == n - 1).all()
    assert (got.length[sep] == 0).all()
    assert got.is_head[sep[:-1] + 1].all()
    before = got.pos[sep[1:] - 1]
    assert (before == len(ref) - 1).sum() == 3
    assert (before == n - 3).sum() == 2


def test_expand_heads_fills_between_heads():
    """Three heads over 8 positions: (pos + k, len - k) after each head,
    smaller only at heads."""
    i32 = torch.int32
    t = torch.tensor([0, 3, 5, 0], dtype=i32)   # one zero pad row
    pos = torch.tensor([9, 2, 20, 0], dtype=i32)
    ln = torch.tensor([0, 5, 3, 0], dtype=i32)
    sml = torch.tensor([False, True, True, True])
    out = expand_heads(t, pos, ln, sml, 3, 8)
    assert out.tolist() == [
        [9, 10, 11, 2, 3, 20, 21, 22],
        [0, -1, -2, 5, 4, 3, 2, 1],
        [0, 0, 0, 1, 0, 1, 0, 0],
        [1, 0, 0, 1, 0, 1, 0, 0]]
