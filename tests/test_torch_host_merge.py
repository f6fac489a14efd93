"""The port's host merge engine and the stage modules it copies, against
the JAX package on the same inputs (the collections of
tests/torch_cases.CASES): the host reference index, the spec scan, the
native scan engine, the head-string suffix sort (the port's torch prefix
doubling at a lowered threshold), tail positioning (native walk, numpy
batches, the two-key path) and merge_from_heads's (run_len, run_char,
counter), with the native library and with the numpy paths. Tolerance:
exact equality, dtypes included."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from torch_cases import CASE_IDS, CASES, assert_same, case_collection
from cmsbwt_tpu.engine import heads as JH
from cmsbwt_tpu.engine import merge as JMG
from cmsbwt_tpu.engine import pipeline as JP
from cmsbwt_tpu.engine import ranking as JR
from cmsbwt_tpu.engine import tails as JT
from cmsbwt_tpu.engine.ms_host import ms_scan_collection as jax_ms_scan
from cmsbwt_tpu.index import host as JI
from cmsbwt_tpu.io import native as JN
from cmsbwt_tpu_torch.config import SEPARATOR
from cmsbwt_tpu_torch.engine import heads as TH
from cmsbwt_tpu_torch.engine import merge as TMG
from cmsbwt_tpu_torch.engine import pipeline as TP
from cmsbwt_tpu_torch.engine import ranking as TR
from cmsbwt_tpu_torch.engine import tails as TT
from cmsbwt_tpu_torch.engine.ms_host import ms_scan_collection
from cmsbwt_tpu_torch.index import device as TDI
from cmsbwt_tpu_torch.index import host as TI
from cmsbwt_tpu_torch.io import native as TN

torch.set_num_threads(1)

INDEX_FIELDS = ("sa", "isa", "lcp", "plcp", "bwt", "x_padded")
MS_FIELDS = ("pos", "length", "smaller", "is_head")


def _seps(sx):
    return np.nonzero(sx == SEPARATOR)[0].astype(np.int64)


def _heads(case):
    """(x_aug, sx, d, JAX host index, JAX heads from the JAX spec scan)."""
    x, sx = case_collection(case)
    index = JI.build_reference_index(x)
    heads = JH.extract_heads(index, jax_ms_scan(index, sx, _seps(sx)), sx)
    return x, sx, int((sx == SEPARATOR).sum()) + 1, index, heads


def _port_heads(jheads):
    return TH.HeadArrays(**{k: copy.deepcopy(v)
                            for k, v in vars(jheads).items()})


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_reference_index_matches_jax(case):
    x, _ = case_collection(case)
    want = JI.build_reference_index(x)
    got = TI.build_reference_index(x)
    for f in INDEX_FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert got.n == want.n
    assert len(got.rank_history) == len(want.rank_history)
    for a, b in zip(want.rank_history, got.rank_history):
        assert_same(a, b, "rank_history")
    dev = TDI.build_reference_index_device(x, "cpu")
    for f in INDEX_FIELDS:
        assert_same(getattr(want, f), getattr(dev, f), "device " + f)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_spec_scan_matches_jax(case):
    x, sx = case_collection(case)
    want = jax_ms_scan(JI.build_reference_index(x), sx, _seps(sx))
    got = ms_scan_collection(TI.build_reference_index(x), sx, _seps(sx))
    for f in MS_FIELDS:
        assert_same(getattr(want, f), getattr(got, f), f)


def _mk(rng, nref, ndocs, snp):
    """tests/test_native_scan.py::_mk."""
    alpha = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(alpha, size=nref)
    docs = []
    for _ in range(ndocs):
        a = ref.copy()
        k = max(1, int(nref * snp))
        idx = rng.choice(nref, k, replace=False)
        a[idx] = rng.choice(alpha, size=k)
        docs.append(a)
    sx = np.concatenate(
        [np.concatenate([d, np.array([SEPARATOR], np.uint8)]) for d in docs])
    return ref, sx, _seps(sx)


@pytest.mark.parametrize("nref,ndocs,snp", [
    (4000, 3, 0.01), (15000, 4, 0.001), (2000, 5, 0.08)])
def test_native_scan_matches_jax_and_spec(nref, ndocs, snp):
    """tests/test_native_scan.py::test_native_scan_matches_host_spec for the
    port's binding, and equal to the JAX binding's heads."""
    from cmsbwt_tpu_torch.io import fasta
    assert TN.get_scan_lib() is not None, "g++ could not build the scan"
    rng = np.random.default_rng(nref + ndocs)
    ref, sx, seps = _mk(rng, nref, ndocs, snp)
    index = TI.build_reference_index(fasta.augment_reference(ref.tobytes()))
    args = (index.x_padded, index.sa, index.isa, index.lcp, index.plcp,
            index.n, sx, seps)
    got = TN.ms_scan_native(*args)
    for a, b in zip(JN.ms_scan_native(*args), got):
        assert_same(a, b)
    spec = TH.extract_heads(index, ms_scan_collection(index, sx, seps), sx)
    for f, b in zip(("t", "pos", "length", "smaller"), got):
        assert_same(getattr(spec, f), b, f)


@pytest.mark.parametrize("case", CASES[:3], ids=CASE_IDS[:3])
def test_head_string_suffix_sort_on_device_matches_jax(case, monkeypatch):
    """Above the threshold (lowered here to 0) the head rank string is
    suffix-sorted by the port's torch prefix doubling on the run's device:
    its SA equals the JAX package's host doubling of the same string."""
    x, _, d, index, jheads = _heads(case)
    JH.fixup_heads(index, jheads)
    classes = JH.build_classes(index, jheads)
    rank_to_head, _ = JR.assign_class_ranks(index, classes, jheads, d)
    want, _, _ = JI.suffix_array_doubling(rank_to_head)
    assert TR._head_string_suffix_sort(rank_to_head, "cpu").dtype == \
        want.dtype    # below the threshold: the host doubling itself
    monkeypatch.setattr(TR, "DEVICE_SORT_THRESHOLD", 0)
    assert_same(want, TR._head_string_suffix_sort(rank_to_head, "cpu"))


def _jax_merge(case, rle_quirk):
    x, sx, d, index, jheads = _heads(case)
    theads = _port_heads(jheads)
    want = JP.merge_from_heads(index, jheads, d, len(sx), rle_quirk)
    return x, sx, d, theads, want


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("rle_quirk", [False, True], ids=["plain", "quirk"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_merge_from_heads_matches_jax(case, rle_quirk, impl, monkeypatch):
    """merge_from_heads on the JAX spec scan's heads: (run_len, run_char,
    counter) equal to the JAX package's, with the native runtime and with
    every native call refused (the numpy paths)."""
    x, sx, d, theads, want = _jax_merge(case, rle_quirk)
    if impl == "numpy":
        monkeypatch.setattr(TN, "get_lib", lambda: None)
    else:
        assert TN.get_lib() is not None, "g++ could not build the runtime"
    got = TP.merge_from_heads(TI.build_reference_index(x), theads, d,
                              len(sx), rle_quirk, "cpu")
    for f in ("run_len", "run_char", "counter"):
        assert_same(getattr(want, f), getattr(got, f), f)
    assert (got.d, got.sn, got.h) == (want.d, want.sn, want.h)


@pytest.mark.parametrize("case", [CASES[2], CASES[4]],
                         ids=[CASE_IDS[2], CASE_IDS[4]])
def test_merge_device_sort_and_two_key_tails_match_jax(case, monkeypatch):
    """The head-string sort on the device (threshold 0) and the two-key
    tail path (the _FORCE_TWO_KEY hook), numpy batches one class at a time
    (a 64-byte -b budget): the same runs and counter as JAX's."""
    x, sx, d, theads, want = _jax_merge(case, False)
    monkeypatch.setattr(TR, "DEVICE_SORT_THRESHOLD", 0)
    monkeypatch.setattr(TT, "_FORCE_TWO_KEY", True)
    monkeypatch.setattr(TT, "_MIN_BATCH_PAIRS", 1)
    got = TP.merge_from_heads(TI.build_reference_index(x), theads, d,
                              len(sx), False, "cpu", buffer_bytes=64)
    for f in ("run_len", "run_char", "counter"):
        assert_same(getattr(want, f), getattr(got, f), f)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tails_native_numpy_and_bucket_counts_match_jax(case, monkeypatch):
    """tests/test_tails_impls.py for the port: the native tail walk and the
    numpy batches give JAX's counter; bucket_counts equals JAX's."""
    x, sx, d, index, jheads = _heads(case)
    ms = jax_ms_scan(index, sx, _seps(sx))
    for a, b in zip(JMG.bucket_counts(index, ms.pos, ms.is_head),
                    TMG.bucket_counts(index, ms.pos, ms.is_head)):
        assert_same(a, b, "bucket_counts")
    JH.fixup_heads(index, jheads)
    classes = JH.build_classes(index, jheads)
    ranked = JR.rank_heads(index, classes, jheads, d)
    want = JT.position_tails(index, classes, ranked)
    assert_same(want, TT.position_tails(index, classes, ranked), "native")
    monkeypatch.setattr(TN, "position_tails_native", lambda *a, **k: None)
    assert_same(want, TT.position_tails(index, classes, ranked), "numpy")
