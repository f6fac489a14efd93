"""The port's CLI (on the CPU) against the C++ reference tool
(baseline/cms-bwt-ref) on the same input list: `.bwt`, `.rl_bwt` and the
counter debug artifact byte-equal, the cases of
tests/test_reference_parity.py, on the jump route, (the `dense_` tests)
the dense route, unblocked, blocked and checkpointed (these also against
the JAX CLI with the same flags), and the routes that end in the host
merge: --backend host|native|device, --merge-backend host after jump and
dense, and the forced int64 route (CMSBWT_SN_BOUND). Tolerance: exact
bytes."""
from __future__ import annotations

import pathlib
import subprocess

import numpy as np
import pytest
import torch

from helpers import make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu_torch import cli

torch.set_num_threads(1)

REF_BIN = pathlib.Path(__file__).resolve().parents[1] / "baseline" / \
    "cms-bwt-ref"


def run_both(tmp_path, lst, rle=False, prefix=None, backend="jump",
             extra=()):
    """Outputs of the reference tool and of the port on ``lst``."""
    flags = (["-r"] if rle else []) + \
        (["-p", str(prefix)] if prefix is not None else [])
    subprocess.run([str(REF_BIN), *flags, "-o", str(tmp_path / "ref"),
                    str(lst)], check=True, capture_output=True)
    assert cli.main([*flags, "-o", str(tmp_path / "ours"), "--device", "cpu",
                     "--lanes", "8", "--backend", backend, *extra,
                     str(lst)]) == 0
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


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("ckpt", [False, True], ids=["blocked",
                                                     "blocked_ckpt"])
def test_parity_dense_blocked(tmp_path, ckpt, rle):
    """--block-chars (tests/test_cli_blocked.py's case), and with
    --checkpoint-dir run twice (the second run loads the saved heads):
    byte-equal to the reference tool and to the JAX CLI."""
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 600)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    fmt = ["-r"] if rle else []
    ext = ".rl_bwt" if rle else ".bwt"
    subprocess.run([str(REF_BIN), *fmt, "-o", str(tmp_path / "ref"),
                    str(lst)], check=True, capture_output=True)
    want = (tmp_path / ("ref" + ext)).read_bytes()
    flags = ["--backend", "dense", "--block-chars", "700", *fmt]
    ck = ["--checkpoint-dir", str(tmp_path / "ck")] if ckpt else []
    for run in range(2 if ckpt else 1):
        assert cli.main([*flags, *ck, "-o", str(tmp_path / f"ours{run}"),
                         "--device", "cpu", str(lst)]) == 0
        assert (tmp_path / (f"ours{run}" + ext)).read_bytes() == want
    assert jax_cli.main([*flags, "-o", str(tmp_path / "jax"),
                         str(lst)]) == 0
    assert (tmp_path / ("jax" + ext)).read_bytes() == want


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend,merge_backend", [
    ("host", "auto"), ("native", "auto"), ("device", "auto"),
    ("jump", "host"), ("dense", "host")],
    ids=["host", "native", "device", "jump-host", "dense-host"])
def test_parity_host_merge_routes(tmp_path, monkeypatch, backend,
                                  merge_backend, rle):
    """The routes that end in the host merge, on the duplicates-and-N
    collection: bytes and debug artifact equal to the reference tool's."""
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(tmp_path / "cache"))
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 600)
    d = mutate(rng, ref, 0.01)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [d, d, b"ACGTNNNNACGT" + d[:100], d])
    ours, refs = run_both(tmp_path, lst, rle=rle, backend=backend,
                          extra=["--merge-backend", merge_backend])
    assert ours == refs
    art = ".counterSmallerThanHead_true"
    assert (tmp_path / ("ours" + art)).read_bytes() == \
        (tmp_path / ("ref" + art)).read_bytes()


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
def test_parity_sn_bound_route(tmp_path, monkeypatch, rle):
    """The int64 route forced at toy scale (CMSBWT_SN_BOUND=1000: 4096-char
    blocks, heads assembled on the host, the host merge), byte-equal to
    the reference tool."""
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    rng = np.random.default_rng(1)
    ref = random_dna(rng, 1500)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.002) for _ in range(6)])
    ours, refs = run_both(tmp_path, lst, rle=rle, backend="dense")
    assert ours == refs
