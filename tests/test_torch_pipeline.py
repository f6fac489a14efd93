"""The port end to end (cmsbwt_tpu_torch.engine.pipeline.compute_bwt and
its CLI, on the CPU): `.bwt`, `.rl_bwt` and the counter debug artifact are
byte-equal to the JAX package's backend='jump', 'dense' and 'host' runs
and to the brute-force BWT; the run never loads JAX; cuda without a card
raises. Tolerance: exact bytes."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import brute_multidoc_bwt, make_inputs, mutate, random_dna
from cmsbwt_tpu.config import Config as JaxConfig
from cmsbwt_tpu.engine.pipeline import compute_bwt as jax_compute_bwt
from cmsbwt_tpu_torch import cli
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.engine.pipeline import compute_bwt

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ART = ".counterSmallerThanHead_true"


def _inputs(tmp_path, seed, ref_len, n_docs, snp, dup=False):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, ref_len)
    docs = [mutate(rng, ref, snp) for _ in range(n_docs)]
    if dup:
        docs[2] = docs[1]  # duplicate doc: counterBad path
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    return lst, ref, docs


@pytest.mark.parametrize("rle", [False, True])
def test_compute_bwt_matches_jax_jump_and_host(tmp_path, rle):
    """Mirrors tests/test_ms_jump.py::test_pipeline_backend_jump."""
    lst, _, _ = _inputs(tmp_path, 5, 700, 5, 0.004, dup=True)
    ext = ".rl_bwt" if rle else ".bwt"
    for name, backend in (("h", "host"), ("j", "jump")):
        jax_compute_bwt(JaxConfig(filename=str(lst),
                                  outname=str(tmp_path / name),
                                  backend=backend, rle=rle, lanes=8,
                                  skip_window=16))
    out = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                             backend="jump", rle=rle, lanes=8,
                             skip_window=16), "cpu")
    assert out["out_path"] == str(tmp_path / ("t" + ext))
    port = (tmp_path / ("t" + ext)).read_bytes()
    assert port == (tmp_path / ("j" + ext)).read_bytes()
    assert port == (tmp_path / ("h" + ext)).read_bytes()
    assert (tmp_path / ("t" + ART)).read_bytes() == \
        (tmp_path / ("h" + ART)).read_bytes()
    assert (tmp_path / "t.log").read_text().count("merge_device") == 1
    assert out["backend"] == "jump"


@pytest.mark.parametrize("rle", [False, True])
def test_dense_compute_bwt_matches_jax_dense(tmp_path, rle):
    """backend='dense' (joint suffix sort + device merge) against the JAX
    package's dense device-resident route, the artifact included."""
    lst, _, _ = _inputs(tmp_path, 5, 700, 5, 0.004, dup=True)
    ext = ".rl_bwt" if rle else ".bwt"
    jax_compute_bwt(JaxConfig(filename=str(lst),
                              outname=str(tmp_path / "j"), backend="dense",
                              merge_backend="device", rle=rle))
    out = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                             backend="dense", merge_backend="device",
                             rle=rle), "cpu")
    assert out["backend"] == "dense"
    assert (tmp_path / ("t" + ext)).read_bytes() == \
        (tmp_path / ("j" + ext)).read_bytes()
    assert (tmp_path / ("t" + ART)).read_bytes() == \
        (tmp_path / ("j" + ART)).read_bytes()
    log = (tmp_path / "t.log").read_text()
    assert "ms_scan" in log and "merge_device" in log
    assert "build_index" not in log


def test_dense_cli_matches_brute_force(tmp_path):
    lst, _, docs = _inputs(tmp_path, 29, 400, 5, 0.03)
    assert cli.main([str(lst), "-o", str(tmp_path / "t"), "--device", "cpu",
                     "--backend", "dense"]) == 0
    sep = np.full(1, 2, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate(
        [np.frombuffer(d, np.uint8), sep]) for d in docs])
    assert (tmp_path / "t.bwt").read_bytes() == brute_multidoc_bwt(sx)


@pytest.mark.parametrize("rle", [False, True])
def test_cli_matches_jax(tmp_path, rle):
    lst, _, _ = _inputs(tmp_path, 17, 600, 6, 0.01)
    ext = ".rl_bwt" if rle else ".bwt"
    jax_compute_bwt(JaxConfig(filename=str(lst),
                              outname=str(tmp_path / "h"), backend="host",
                              rle=rle))
    argv = [str(lst), "-o", str(tmp_path / "t"), "--device", "cpu",
            "--lanes", "8"] + (["-r"] if rle else [])
    assert cli.main(argv) == 0
    assert (tmp_path / ("t" + ext)).read_bytes() == \
        (tmp_path / ("h" + ext)).read_bytes()


def test_compute_bwt_matches_brute_force(tmp_path):
    lst, _, docs = _inputs(tmp_path, 23, 500, 4, 0.02)
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                       backend="jump", lanes=5, skip_window=16), "cpu")
    sep = np.full(1, 2, np.uint8)
    sx = np.concatenate([sep] + [np.concatenate(
        [np.frombuffer(d, np.uint8), sep]) for d in docs])
    assert (tmp_path / "t.bwt").read_bytes() == brute_multidoc_bwt(sx)


def test_empty_collection(tmp_path):
    ref_path = tmp_path / "ref.txt"
    ref_path.write_bytes(b"ACGTACGT")
    coll = tmp_path / "coll.fa"
    coll.write_bytes(b"")
    lst = tmp_path / "input.txt"
    lst.write_text(f"{ref_path}\n{coll}\n")
    out = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                             backend="jump"), "cpu")
    assert out["bytes"] == 0 and (tmp_path / "t.bwt").read_bytes() == b""


def _cli_loads_no_jax(tmp_path, *flags):
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    code = (
        "import sys\n"
        "from cmsbwt_tpu_torch.cli import main\n"
        f"main([{str(lst)!r}, '-o', {str(tmp_path / 't')!r}, "
        f"'--device', 'cpu', *{list(flags)!r}])\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib'))\n"
        "assert not loaded, loaded\n"
        "print('NO_JAX')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_JAX" in r.stdout
    assert (tmp_path / "t.bwt").stat().st_size > 0


def test_cli_run_leaves_jax_unloaded(tmp_path):
    _cli_loads_no_jax(tmp_path, "--lanes", "4")


def test_dense_cli_run_leaves_jax_unloaded(tmp_path):
    _cli_loads_no_jax(tmp_path, "--backend", "dense")


def test_port_sources_never_import_jax():
    for src in (ROOT / "cmsbwt_tpu_torch").rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"])
                        and words[1].split(".")[0] in ("jax", "jaxlib")), \
                (src, line)


def test_cuda_without_card_raises(tmp_path, monkeypatch):
    """device='cuda' on a machine without a usable CUDA device is an error,
    not a silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    cfg = Config(filename=str(lst), outname=str(tmp_path / "t"),
                 backend="jump")
    with pytest.raises(RuntimeError, match="cuda"):
        compute_bwt(cfg, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([str(lst), "-o", str(tmp_path / "t")])  # default: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main([str(lst), "-o", str(tmp_path / "t"), "--backend", "dense"])
    assert not (tmp_path / "t.bwt").exists()


@pytest.mark.parametrize("backend,merge_backend", [
    ("auto", "auto"), ("dense", "host"), ("host", "auto"),
    ("jump", "host"), ("jump", "sharded")])
def test_unported_routes_raise(tmp_path, backend, merge_backend):
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    cfg = Config(filename=str(lst), outname=str(tmp_path / "t"),
                 backend=backend, merge_backend=merge_backend)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        compute_bwt(cfg, "cpu")


@pytest.mark.parametrize("flag", [
    ["--block-chars", "1000"], ["--parallel"], ["--checkpoint-dir", "ck"]])
def test_unported_options_rejected(tmp_path, flag):
    """Options of routes not ported yet are refused, not ignored."""
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main([str(lst), "-o", str(tmp_path / "t"), "--device", "cpu",
                  *flag])
    assert not (tmp_path / "t.bwt").exists()
