"""The port end to end (cmsbwt_tpu_torch.engine.pipeline.compute_bwt and
its CLI, on the CPU): `.bwt`, `.rl_bwt` and the counter debug artifact are
byte-equal to the JAX package's runs on every ported route (backend jump,
dense, device, native and host; the device and the host merge) and to the
brute-force BWT, the dense route's blocked and checkpointed forms to the
JAX CLI's; a checkpoint directory written by either package is resumed by
the other without a scan; the reference-index cache is shared with the
JAX package; collections at or above the int32 bound take the blocked
scan and the host merge; the merge engine follows the JAX rules and, on a
card, the merge's memory ceiling; the memory guard chooses blocks; the
sharded merge and --parallel over two cards run; the run never loads JAX;
cuda without a card raises. Tolerance: exact bytes."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import brute_multidoc_bwt, make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
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
            "--backend", "jump", "--lanes", "8"] + (["-r"] if rle else [])
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
    _cli_loads_no_jax(tmp_path, "--backend", "jump", "--lanes", "4")


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
    ("auto", "auto"), ("dense", "sharded"), ("device", "sharded"),
    ("native", "sharded"), ("jump", "sharded")])
def test_unported_routes_raise(tmp_path, backend, merge_backend):
    """merge_backend='sharded' and backend='auto', each refused until it
    was ported, now run: bytes equal to the JAX package's run. JAX's
    device and native routes ignore merge_backend, as the port's do; after
    jump and dense the port runs the sharded merge (one rank on the CPU;
    test_torch_sharded_merge.py holds it at R = 1, 2 and 4) and JAX here
    its device merge, whose bytes its tests hold equal to its sharded
    merge's (its 8-device sharded programs take ~50 s to build on the
    CPU). test_torch_auto.py holds auto's choices."""
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    cfg = Config(filename=str(lst), outname=str(tmp_path / "t"),
                 backend=backend, merge_backend=merge_backend)
    out = compute_bwt(cfg, "cpu")
    jax_mb = "device" if backend in ("dense", "jump") else merge_backend
    want = jax_compute_bwt(JaxConfig(filename=str(lst),
                                     outname=str(tmp_path / "j"),
                                     backend=backend, merge_backend=jax_mb,
                                     index_cache_dir=""))
    assert out["backend"] == want["backend"]
    assert (tmp_path / "t.bwt").read_bytes() == \
        (tmp_path / "j.bwt").read_bytes()
    if backend in ("dense", "jump"):
        assert "merge_sharded" in (tmp_path / "t.log").read_text()


@pytest.mark.parametrize("flag", [["--parallel"]])
def test_unported_options_rejected(tmp_path, flag):
    """--parallel, refused until it was ported, now runs on one device
    (test_torch_parallel_blocked.py holds it to the JAX package): the
    dense route's bytes, equal to the JAX CLI's."""
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    assert cli.main([str(lst), "-o", str(tmp_path / "t"), "--device", "cpu",
                     "--backend", "dense", *flag]) == 0
    assert jax_cli.main([str(lst), "-o", str(tmp_path / "j"), "--backend",
                         "dense", *flag]) == 0
    assert (tmp_path / "t.bwt").read_bytes() == \
        (tmp_path / "j.bwt").read_bytes()


def test_parallel_on_more_than_one_card_raises(tmp_path, monkeypatch):
    """--parallel over more than one CUDA device, refused until it was
    ported, is the mesh scan: with two cards (the count monkeypatched, to
    reach the decision on the CPU) the CLI hands the scan and the sharded
    merge to two ranks, which run here as gloo ranks on the CPU; bytes
    equal to the JAX CLI's --parallel run. The collection, which the
    pipeline parses on the run's device, is read onto the CPU (the plain
    parse), as no card is here."""
    from cmsbwt_tpu_torch.io import parse
    from cmsbwt_tpu_torch.parallel import distributed
    read_raw = parse.read_raw
    monkeypatch.setattr(parse, "read_raw",
                        lambda path, device: read_raw(path, "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    real = distributed.run

    def on_cpu(fn, inputs, device, n_devices=None):
        calls.append((torch.device(device).type,
                      distributed.n_ranks(device, n_devices)))
        return real(fn, inputs, "cpu", 2)
    monkeypatch.setattr(distributed, "run", on_cpu)
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    flags = ["--backend", "dense", "--parallel", "--block-chars", "300"]
    assert cli.main([str(lst), "-o", str(tmp_path / "t"), "--device", "cuda",
                     *flags, "--merge-backend", "sharded"]) == 0
    assert calls == [("cuda", 2), ("cuda", 2)]   # the mesh scan, the merge
    assert jax_cli.main([str(lst), "-o", str(tmp_path / "j"), *flags]) == 0
    assert (tmp_path / "t.bwt").read_bytes() == \
        (tmp_path / "j.bwt").read_bytes()


@pytest.mark.parametrize("flag", [["--block-chars", "1000"],
                                  ["--checkpoint-dir", "CK"]],
                         ids=["block_chars", "checkpoint_dir"])
def test_dense_options_match_jax_cli(tmp_path, flag):
    """--block-chars (the blocked scan) and --checkpoint-dir (unblocked:
    the whole collection saved as one block, then loaded by a rerun) run,
    and their bytes and debug artifact equal the JAX CLI's with the same
    flags."""
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    outs = {}
    runs = (("t", cli.main), ("j", jax_cli.main))
    if flag[0] == "--checkpoint-dir":
        runs += (("t2", cli.main),)
    for who, main in runs:
        argv = [str(tmp_path / f"ck_{who[0]}") if a == "CK" else a
                for a in flag]
        argv += ["--device", "cpu"] if who[0] == "t" else []
        assert main([str(lst), "-o", str(tmp_path / who), "--backend",
                     "dense", *argv]) == 0
        outs[who] = [(tmp_path / (who + ext)).read_bytes()
                     for ext in (".bwt", ART)]
    assert outs["t"] == outs["j"] == outs.get("t2", outs["t"])
    assert len(outs["t"][0]) > 0
    if flag[0] == "--checkpoint-dir":
        # the whole run's bundle (the JAX package's) and the one block
        saved = sorted(os.listdir(tmp_path / "ck_t"))
        assert len(saved) == 2 and saved[0].startswith("dense_block_0.")
        assert saved[1].startswith("dense_heads.")
        assert saved[1] in os.listdir(tmp_path / "ck_j")


def test_hbm_guard_routes_dense_through_blocks(tmp_path, monkeypatch):
    """A tiny CMSBWT_HBM_GB budget makes the memory guard choose blocks
    (tests/test_hbm_guard.py for the port): the blocked scan runs, with
    the guard's 8 Mi-char floor, and the bytes equal the unblocked run's."""
    from cmsbwt_tpu_torch.ops import ms_dense as md
    lst, _, _ = _inputs(tmp_path, 3, 3000, 2, 0.01)
    calls = []
    orig = md.ms_dense_heads_blocked_on_device

    def spy(*a, **kw):
        calls.append(a[3])
        return orig(*a, **kw)

    monkeypatch.setattr(md, "ms_dense_heads_blocked_on_device", spy)
    monkeypatch.setenv("CMSBWT_HBM_GB", "0.000001")
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "a"),
                       backend="dense"), "cpu")
    assert calls == [8 << 20]
    monkeypatch.delenv("CMSBWT_HBM_GB")
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "b"),
                       backend="dense"), "cpu")
    assert calls == [8 << 20]    # no budget on the CPU: unblocked
    assert (tmp_path / "a.bwt").read_bytes() == \
        (tmp_path / "b.bwt").read_bytes()


def test_parallel_block_chars_capped_by_guard(tmp_path, monkeypatch):
    """dense_parallel without dense_block_chars takes the JAX pipeline's
    one-device block (sn, with its 64 Ki floor), and the memory guard's
    block where the guard gives a smaller one (here a guard made to give
    1000 chars under a budget); both run the blocked loop, and the bytes
    equal the unblocked run's."""
    from cmsbwt_tpu_torch.ops import ms_dense as md
    lst, _, _ = _inputs(tmp_path, 3, 3000, 2, 0.01)
    calls = []
    orig = md.ms_dense_heads_blocked_on_device

    def spy(*a, **kw):
        calls.append(a[3])
        return orig(*a, **kw)

    monkeypatch.setattr(md, "ms_dense_heads_blocked_on_device", spy)
    monkeypatch.setattr(md, "dense_block_chars",
                        lambda n, sn, budget: budget and 1000)
    for tag, gb in (("a", "0.000001"), ("b", None)):
        if gb:
            monkeypatch.setenv("CMSBWT_HBM_GB", gb)
        else:
            monkeypatch.delenv("CMSBWT_HBM_GB", raising=False)
        compute_bwt(Config(filename=str(lst), outname=str(tmp_path / tag),
                           backend="dense", dense_parallel=True), "cpu")
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "c"),
                       backend="dense"), "cpu")
    assert calls == [1000, 1 << 16]
    for tag in "ab":
        assert (tmp_path / f"{tag}.bwt").read_bytes() == \
            (tmp_path / "c.bwt").read_bytes()


@pytest.mark.parametrize("n,sn,gib", [
    (1_000_000, 20_000_000, 1e-6), (1_000_000, 20_000_000, 2.0),
    (1_000_000, 20_000_000, 6.0), (5_000_128, 500_000_101, 78.2),
    (5_000_128, 100_000_021, 78.2), (2_000_128, 20_000_011, 80.0)])
def test_dense_block_chars_matches_jax_formula(n, sn, gib):
    """The guard's choice is the JAX pipeline's (pipeline.py:341-354) with
    the port's 240 bytes per joint char in place of 260."""
    from cmsbwt_tpu.utils.jaxcache import bucket_size as bs
    from cmsbwt_tpu_torch.ops.ms_dense import (DENSE_BYTES_PER_CHAR,
                                               dense_block_chars)
    assert DENSE_BYTES_PER_CHAR == 240
    budget = gib * 2**30
    want = None
    if 240 * (bs(n) + bs(sn + 1)) > budget:
        want = max(8 << 20, int((budget / 240 - bs(n)) * 0.6))
    assert dense_block_chars(n, sn, budget) == want
    assert dense_block_chars(n, sn, None) is None


@pytest.mark.parametrize("sn,free,refused", [
    (500_000_101, 84.4e9, False), (20_000_011, 2**31, False),
    (900_000_000, 84.4e9, True), (2_000_000_000, 84.4e9, True)])
def test_merge_memory_check(sn, free, refused):
    """The device merge is not blocked: asked for, a merge that needs more
    than the free device memory (96 B per char) is refused, naming the
    host merge that takes it."""
    from cmsbwt_tpu_torch.engine.device_merge import (MERGE_BYTES_PER_CHAR,
                                                      merge_fits,
                                                      merge_memory_check)
    assert MERGE_BYTES_PER_CHAR == 96
    assert merge_fits(sn, free) is not refused
    if not refused:
        merge_memory_check(sn, free)
        return
    with pytest.raises(ValueError, match="merge_backend='host'"):
        merge_memory_check(sn, free)


GB = 1e9
SN_1G = 1_000_000_101        # 5 Mbp x 200 docs: above the card's ceiling


def test_free_memory_counts_the_allocator_cache(monkeypatch):
    """The memory guard's budget and the merge's ceiling read a card's
    free memory as a new allocation can have it: mem_get_info's free bytes
    plus what torch's caching allocator holds reserved but unallocated.
    (Read from mem_get_info alone, a 500 Mchar run took the host merge
    whenever an earlier run in the same process had left its segments
    cached.)"""
    from cmsbwt_tpu_torch.engine import pipeline as pl
    from cmsbwt_tpu_torch.ops import ms_dense as md
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (30 * GB, 85 * GB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 50 * GB)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 2 * GB)
    monkeypatch.delenv("CMSBWT_HBM_GB", raising=False)
    monkeypatch.delenv("CMSBWT_MERGE_BACKEND", raising=False)
    assert md.free_device_bytes("cuda") == 78 * GB
    assert md.dense_budget("cuda") == 78 * GB
    assert pl._choose_merge(Config(backend="dense"), torch.device("cuda"),
                            500_000_101, False) == "device"
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 2 * GB)
    assert pl._choose_merge(Config(backend="dense"), torch.device("cuda"),
                            500_000_101, False) == "host"


@pytest.mark.parametrize("backend,mb,dev,n,sn,env,want", [
    ("jump", "auto", "cpu", 2000, 20000, None, "device"),
    ("dense", "auto", "cpu", 2000, 20000, None, "host"),
    ("jump", "auto", "cuda", 2_000_128, 20_000_011, None, "device"),
    ("jump", "auto", "cuda", 30_000, 90_000_000, None, "device"),  # SARS
    ("dense", "auto", "cuda", 30_000, 90_000_000, None, "device"),
    ("dense", "auto", "cuda", 5_000_128, SN_1G, None, "host"),    # ceiling
    ("jump", "auto", "cuda", 5_000_128, SN_1G, None, "host"),
    ("dense", "device", "cuda", 5_000_128, SN_1G, None, ValueError),
    ("dense", "auto", "cuda", 5_000_128, SN_1G, "device", ValueError),
    ("dense", "host", "cuda", 2000, 20000, None, "host"),
    ("dense", "auto", "cpu", 2000, 20000, "device", "device"),
    ("jump", "auto", "cpu", 2000, 20000, "host", "host"),
    ("jump", "device", "cpu", 5_000_128, SN_1G, None, "device"),
], ids=["jump-cpu", "dense-cpu", "jump-card", "jump-card-sars",
        "dense-card-no-sars-rule", "dense-ceiling", "jump-ceiling",
        "device-above-ceiling", "env-device-above-ceiling", "host",
        "env-device", "env-host", "no-ceiling-on-cpu"])
def test_merge_engine_routing(monkeypatch, backend, mb, dev, n, sn, env,
                              want):
    """The merge engine of the jump and dense routes: the JAX rules with
    cuda as the accelerator and cpu as the CPU-only process, but on a card
    the device merge at the SARS shape too (the JAX package's host merge
    there was measured on a TPU; on the H100 the device merge is faster,
    PERF.md §5), CMSBWT_MERGE_BACKEND over auto, and on a card (84.4 GB
    free here: 80.4 GB free by mem_get_info and 4 GB cached by torch's
    allocator) auto's host merge above the device merge's ceiling, where
    an asked-for device merge is refused."""
    from cmsbwt_tpu_torch.engine import pipeline as pl
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (80.4 * GB, 85.0 * GB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda *a: 5.0 * GB)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 1.0 * GB)
    if env:
        monkeypatch.setenv("CMSBWT_MERGE_BACKEND", env)
    else:
        monkeypatch.delenv("CMSBWT_MERGE_BACKEND", raising=False)
    cfg = Config(backend=backend, merge_backend=mb)
    if want is ValueError:
        with pytest.raises(ValueError, match="merge_backend='host'"):
            pl._choose_merge(cfg, torch.device(dev), sn, False)
        return
    assert pl._choose_merge(cfg, torch.device(dev), sn, False) == want
    assert pl._choose_merge(cfg, torch.device(dev), sn, True) == "host"


ROUTES = [("host", "auto"), ("native", "auto"), ("device", "auto"),
          ("jump", "host"), ("dense", "host")]
ROUTE_IDS = ["host", "native", "device", "jump-host", "dense-host"]


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend,merge_backend", ROUTES, ids=ROUTE_IDS)
def test_host_merge_routes_match_jax_cli(tmp_path, monkeypatch, backend,
                                         merge_backend, rle):
    """--backend host|native|device and --merge-backend host through the
    port's CLI: bytes and debug artifact equal to the JAX CLI's (JAX's
    compute_bwt for native, which its CLI does not offer); the native
    engine names itself in the .log."""
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(tmp_path / "cache"))
    lst, _, _ = _inputs(tmp_path, 5, 700, 5, 0.004, dup=True)
    ext = ".rl_bwt" if rle else ".bwt"
    fmt = ["-r"] if rle else []
    argv = [str(lst), "--backend", backend, "--merge-backend",
            merge_backend, "--lanes", "8", *fmt]
    assert cli.main(argv + ["-o", str(tmp_path / "t"), "--device",
                            "cpu"]) == 0
    if backend == "native":
        jax_compute_bwt(JaxConfig(filename=str(lst), rle=rle,
                                  outname=str(tmp_path / "j"),
                                  backend="native", index_cache_dir=""))
    else:
        assert jax_cli.main(argv + ["-o", str(tmp_path / "j")]) == 0
    for e in (ext, ART):
        assert (tmp_path / ("t" + e)).read_bytes() == \
            (tmp_path / ("j" + e)).read_bytes(), e
    log = (tmp_path / "t.log").read_text()
    assert "head_fixup" in log and "merge_device" not in log
    assert ("scan_engine: native" in log) == (backend == "native")


def test_native_without_toolchain_runs_the_spec_scan(tmp_path, monkeypatch):
    """When g++ cannot build the scan engine the native backend runs the
    host spec scan (host code), names it in the .log, and gives the same
    bytes."""
    from cmsbwt_tpu_torch.io import native as tn
    lst, _, _ = _inputs(tmp_path, 17, 600, 6, 0.01)
    cfg = lambda o: Config(filename=str(lst), outname=str(tmp_path / o),
                           backend="native", index_cache_dir="")
    compute_bwt(cfg("a"), "cpu")
    monkeypatch.setattr(tn, "get_scan_lib", lambda: None)
    compute_bwt(cfg("b"), "cpu")
    assert (tmp_path / "a.bwt").read_bytes() == \
        (tmp_path / "b.bwt").read_bytes()
    assert "scan_engine: native" in (tmp_path / "a.log").read_text()
    assert "scan_engine: host_spec" in (tmp_path / "b.log").read_text()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_index_cache_shared_with_jax(tmp_path, monkeypatch, writer):
    """The reference-index cache has the JAX package's directory and
    fingerprint: an index one package saved is loaded by the other, which
    then builds none; the bytes are equal."""
    from cmsbwt_tpu.engine import pipeline as jpl
    from cmsbwt_tpu_torch.engine import pipeline as tpl
    lst, _, _ = _inputs(tmp_path, 17, 600, 6, 0.01)
    cache = tmp_path / "cache"
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", str(cache))
    runs = {"jax": lambda: jax_compute_bwt(JaxConfig(
                filename=str(lst), outname=str(tmp_path / "j"),
                backend="native")),
            "port": lambda: compute_bwt(Config(
                filename=str(lst), outname=str(tmp_path / "t"),
                backend="native"), "cpu")}
    runs[writer]()
    assert [f.startswith("ref_index.") for f in os.listdir(cache)] == [True]
    reader = "port" if writer == "jax" else "jax"
    mod = tpl if reader == "port" else jpl

    def built(*a, **k):
        raise AssertionError("the cached index was not used")
    monkeypatch.setattr(mod, "build_reference_index", built)
    monkeypatch.setattr(mod, "_build_host_index_fast", built)
    runs[reader]()
    assert (tmp_path / "t.bwt").read_bytes() == \
        (tmp_path / "j.bwt").read_bytes()


def _no_scan(monkeypatch, md, names):
    def scanned(*a, **k):
        raise AssertionError("the resuming run scanned")
    for name in names:
        monkeypatch.setattr(md, name, scanned)


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, monkeypatch, writer,
                                            rle):
    """A --checkpoint-dir that one package's dense run wrote is resumed by
    the other's from the whole-run dense_heads bundle: no scan runs (every
    scan entry of the resuming package raises), and the bytes and debug
    artifact equal the writer's."""
    from cmsbwt_tpu.ops import ms_dense as jmd
    from cmsbwt_tpu_torch.ops import ms_dense as tmd
    lst, _, _ = _inputs(tmp_path, 3, 300, 3, 0.01)
    ck = str(tmp_path / "ck")
    fmt = ["-r"] if rle else []
    port = lambda o: cli.main([str(lst), "-o", str(tmp_path / o), "--device",
                               "cpu", "--backend", "dense",
                               "--checkpoint-dir", ck, *fmt])
    jax = lambda o: jax_cli.main([str(lst), "-o", str(tmp_path / o),
                                  "--backend", "dense", "--checkpoint-dir",
                                  ck, *fmt])
    first, second = (jax, port) if writer == "jax" else (port, jax)
    assert first("a") == 0
    assert any(f.startswith("dense_heads.") for f in os.listdir(ck))
    if writer == "jax":
        _no_scan(monkeypatch, tmd, ["ms_dense_heads_on_device",
                                    "ms_dense_heads_blocked_on_device"])
    else:
        _no_scan(monkeypatch, jmd, ["ms_dense_heads", "ms_dense_heads_blocked",
                                    "ms_dense_heads_on_device",
                                    "ms_dense_heads_blocked_on_device"])
    assert second("b") == 0
    ext = ".rl_bwt" if rle else ".bwt"
    for e in (ext, ART):
        assert (tmp_path / ("a" + e)).read_bytes() == \
            (tmp_path / ("b" + e)).read_bytes(), e


@pytest.mark.parametrize("rle", [False, True])
def test_sn_bound_route_byte_equal(tmp_path, monkeypatch, rle):
    """tests/test_sn_bound.py for the port (test_sn_bound_route_auto has
    its backend=auto cases):
    with CMSBWT_SN_BOUND=1000 the dense route runs blocks of
    max(min(chunk_cap_bytes // 8, bound // 2), 4096) = 4096 chars (two
    over this collection) whose heads go to the host (int64 t), then the
    host merge: bytes equal to the JAX run without the bound and to the
    JAX run with it."""
    from cmsbwt_tpu_torch.ops import ms_dense as md
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 1000)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.02) for _ in range(6)])
    ext = ".rl_bwt" if rle else ".bwt"
    jax_compute_bwt(JaxConfig(filename=str(lst), outname=str(tmp_path / "a"),
                              rle=rle))
    calls = []
    orig = md.ms_dense_heads_blocked_on_device

    def spy(*a, **kw):
        calls.append((a[3], kw.get("to_host")))
        return orig(*a, **kw)
    monkeypatch.setattr(md, "ms_dense_heads_blocked_on_device", spy)
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    jax_compute_bwt(JaxConfig(filename=str(lst), outname=str(tmp_path / "j"),
                              rle=rle, backend="dense"))
    compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t"),
                       rle=rle, backend="dense"), "cpu")
    assert calls == [(4096, True)]
    want = (tmp_path / ("a" + ext)).read_bytes()
    assert (tmp_path / ("t" + ext)).read_bytes() == want
    assert (tmp_path / ("j" + ext)).read_bytes() == want
    assert "head_fixup" in (tmp_path / "t.log").read_text()


@pytest.mark.parametrize("native_ok", [True, False], ids=["native", "no_lib"])
def test_sn_bound_route_auto(tmp_path, monkeypatch, native_ok):
    """backend='auto' above the bound (CMSBWT_SN_BOUND=1000), as the JAX
    package resolves it: with the native library, its int64-safe native
    scan and the host merge (no blocked scan); without it (and
    AUTO_DENSE_MIN_CHARS lowered to 1, so the CPU rule picks jump), the
    jump scan turned into the blocked dense int64 route. Bytes equal to
    the JAX runs with and without the bound."""
    from cmsbwt_tpu.engine import pipeline as jpl
    from cmsbwt_tpu.io import native as jnative
    from cmsbwt_tpu_torch.engine import pipeline as tpl
    from cmsbwt_tpu_torch.io import native as tnative
    from cmsbwt_tpu_torch.ops import ms_dense as md
    monkeypatch.setenv("CMSBWT_INDEX_CACHE", "")
    if not native_ok:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "get_scan_lib", lambda: None)
        for mod in (jpl, tpl):
            monkeypatch.setattr(mod, "AUTO_DENSE_MIN_CHARS", 1)
    rng = np.random.default_rng(21)
    ref = random_dna(rng, 1000)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.02) for _ in range(6)])
    jax_compute_bwt(JaxConfig(filename=str(lst), outname=str(tmp_path / "a"),
                              backend="host"))
    calls = []
    orig = md.ms_dense_heads_blocked_on_device

    def spy(*a, **kw):
        calls.append((a[3], kw.get("to_host")))
        return orig(*a, **kw)
    monkeypatch.setattr(md, "ms_dense_heads_blocked_on_device", spy)
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    want = jax_compute_bwt(JaxConfig(filename=str(lst),
                                     outname=str(tmp_path / "j")))
    out = compute_bwt(Config(filename=str(lst), outname=str(tmp_path / "t")),
                      "cpu")
    assert out["backend"] == want["backend"] == \
        ("native" if native_ok else "dense")
    assert calls == ([] if native_ok else [(4096, True)])
    for who in ("t", "j"):
        assert (tmp_path / f"{who}.bwt").read_bytes() == \
            (tmp_path / "a.bwt").read_bytes(), who
    assert "head_fixup" in (tmp_path / "t.log").read_text()


@pytest.mark.parametrize("backend,merge_backend", [
    ("jump", "auto"), ("device", "auto"), ("dense", "device"),
    ("host", "device")])
def test_sn_bound_rejects_int32_paths(tmp_path, monkeypatch, backend,
                                      merge_backend):
    """tests/test_sn_bound.py::test_sn_bound_rejects_int32_paths for the
    port: the int32 scans and an asked-for device merge refuse."""
    rng = np.random.default_rng(22)
    ref = random_dna(rng, 800)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.02) for _ in range(4)])
    monkeypatch.setenv("CMSBWT_SN_BOUND", "1000")
    cfg = Config(filename=str(lst), outname=str(tmp_path / "x"),
                 backend=backend, merge_backend=merge_backend)
    with pytest.raises(ValueError, match="int32"):
        compute_bwt(cfg, "cpu")
    assert not (tmp_path / "x.bwt").exists()
