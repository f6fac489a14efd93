"""The port's CLI (on the CPU) against the C++ reference tool
(baseline/cms-bwt-ref) on the same input list: `.bwt`, `.rl_bwt` and the
counter debug artifact byte-equal, the cases of
tests/test_reference_parity.py, on the jump route and (the `dense_` tests)
the dense route. Tolerance: exact bytes."""
from __future__ import annotations

import pathlib
import subprocess

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu_torch import cli

torch.set_num_threads(1)

REF_BIN = pathlib.Path(__file__).resolve().parents[1] / "baseline" / \
    "cms-bwt-ref"


def run_both(tmp_path, lst, rle=False, prefix=None, backend="jump"):
    """Outputs of the reference tool and of the port on ``lst``."""
    flags = (["-r"] if rle else []) + \
        (["-p", str(prefix)] if prefix is not None else [])
    subprocess.run([str(REF_BIN), *flags, "-o", str(tmp_path / "ref"),
                    str(lst)], check=True, capture_output=True)
    assert cli.main([*flags, "-o", str(tmp_path / "ours"), "--device", "cpu",
                     "--lanes", "8", "--backend", backend, str(lst)]) == 0
    ext = ".rl_bwt" if rle else ".bwt"
    return ((tmp_path / ("ours" + ext)).read_bytes(),
            (tmp_path / ("ref" + ext)).read_bytes())


@pytest.mark.parametrize("seed,reflen,ndocs,snp,rle", [
    (0, 400, 4, 0.01, False),
    (0, 400, 4, 0.01, True),
    (1, 1500, 6, 0.002, False),
    (1, 1500, 6, 0.002, True),
    (2, 800, 3, 0.05, True),
])
def test_parity_mutated(tmp_path, seed, reflen, ndocs, snp, rle):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, reflen)
    docs = [mutate(rng, ref, snp) for _ in range(ndocs)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    ours, refs = run_both(tmp_path, lst, rle=rle)
    assert ours == refs


@pytest.mark.parametrize("rle", [False, True])
def test_parity_duplicates_and_n_chars(tmp_path, rle):
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [d, d, b"ACGTNNNNACGT" + d[:100], d])
    ours, refs = run_both(tmp_path, lst, rle=rle)
    assert ours == refs


def test_parity_prefix_flag(tmp_path):
    rng = np.random.default_rng(4)
    ref = random_dna(rng, 500)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.01) for _ in range(4)])
    ours, refs = run_both(tmp_path, lst, prefix=700)
    assert ours == refs


def test_parity_debug_artifact(tmp_path):
    """The small-reference path writes <out>.counterSmallerThanHead_true."""
    rng = np.random.default_rng(6)
    ref = random_dna(rng, 400)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.02) for _ in range(3)])
    run_both(tmp_path, lst)
    art = ".counterSmallerThanHead_true"
    assert (tmp_path / ("ours" + art)).read_bytes() == \
        (tmp_path / ("ref" + art)).read_bytes()


def test_parity_raw_reference_with_dollar(tmp_path):
    """A raw (non-FASTA) reference file ending in '$\\n'."""
    rng = np.random.default_rng(7)
    ref = random_dna(rng, 300)
    lst, _, _ = make_inputs(tmp_path, ref + b"$\n",
                            [mutate(rng, ref, 0.01) for _ in range(2)])
    ours, refs = run_both(tmp_path, lst)
    assert ours == refs


@pytest.mark.parametrize("seed,reflen,ndocs,snp,rle", [
    (0, 400, 4, 0.01, False),
    (1, 1500, 6, 0.002, True),
    (2, 800, 3, 0.05, True),
])
def test_parity_dense_mutated(tmp_path, seed, reflen, ndocs, snp, rle):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, reflen)
    docs = [mutate(rng, ref, snp) for _ in range(ndocs)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    ours, refs = run_both(tmp_path, lst, rle=rle, backend="dense")
    assert ours == refs


@pytest.mark.parametrize("rle", [False, True])
def test_parity_dense_duplicates_and_n_chars(tmp_path, rle):
    """Repeated N bytes: the dense route takes the narrow (byte-8) seed."""
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [d, d, b"ACGTNNNNACGT" + d[:100], d])
    ours, refs = run_both(tmp_path, lst, rle=rle, backend="dense")
    assert ours == refs


def test_parity_dense_debug_artifact_and_prefix(tmp_path):
    rng = np.random.default_rng(6)
    ref = random_dna(rng, 400)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.02) for _ in range(3)])
    ours, refs = run_both(tmp_path, lst, prefix=900, backend="dense")
    assert ours == refs
    art = ".counterSmallerThanHead_true"
    assert (tmp_path / ("ours" + art)).read_bytes() == \
        (tmp_path / ("ref" + art)).read_bytes()
