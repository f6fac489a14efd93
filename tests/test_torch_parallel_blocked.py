"""The port's --parallel dense scan (cmsbwt_tpu_torch/parallel/blocked.py)
against the JAX package's: ms_dense_heads_parallel with devices=[cpu, cpu]
field for field against JAX's ms_dense_heads_parallel (on its 8 virtual
CPU devices) and against the port's sequential blocked loop and unblocked
scan, the twins of tests/test_parallel_blocked.py included; two distinct
cards run the mesh scan; the CLI's --parallel bytes equal the JAX CLI's; block
checkpoints resume across {parallel, sequential} x {port, JAX} with every
scan entry of the resuming side made to raise, the port chaining every
block it loads (the JAX sequential loop does not: its resume of blocks
its parallel loop saved is held here as the reference's fault). Inputs
are made with numpy from seeds. Tolerance: exact (values, shapes, dtypes
and bytes)."""
from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from helpers import make_fasta, make_inputs, mutate, random_dna
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.engine import device_merge as JM
from cmsbwt_tpu.io import fasta as jfasta
from cmsbwt_tpu.ops import ms_dense as MD
from cmsbwt_tpu.parallel.blocked import ms_dense_heads_parallel as jax_par
from cmsbwt_tpu_torch import cli
from cmsbwt_tpu_torch.engine.pipeline import download_heads_result
from cmsbwt_tpu_torch.ops import ms_dense as TD
from cmsbwt_tpu_torch.parallel import blocked as TP
from torch_cases import CASE_IDS, CASES, assert_same, case_collection

torch.set_num_threads(1)

FIELDS = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
          "ref_sa", "ref_isa", "ref_bwt")
CPUS = ["cpu", "cpu"]


def _assert_result(want, got, fields=FIELDS):
    for f in fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    for f in ("h", "sn", "irreducible"):
        assert getattr(want, f) == getattr(got, f), f


def _assert_device_heads(dev, got):
    """A device DeviceHeadsResult's heads and reference index against a
    host DenseHeadsResult (the sequential loop's irreducible is summed
    over other block tries, so it is not compared)."""
    assert dev.h == got.h
    for f in FIELDS:
        k = dev.h if f.startswith("head_") else dev.n
        a = getattr(got, f)
        assert_same(a, getattr(dev, f)[:k].numpy().astype(a.dtype), f)


def _build(tmp_path, ref, docs):
    coll_path = tmp_path / "c.fa"
    coll_path.write_bytes(make_fasta(docs))
    coll = jfasta.parse_collection(str(coll_path), 1 << 60)
    return np.frombuffer(jfasta.augment_reference(ref), np.uint8), coll.sx


@pytest.mark.parametrize("seed,reflen,ndocs,snp,block", [
    (0, 300, 5, 0.02, 250),
    (1, 400, 6, 0.005, 333),
])
def test_parallel_blocks_match_single(tmp_path, seed, reflen, ndocs, snp,
                                      block):
    """tests/test_parallel_blocked.py's twin: the blocks' heads are the
    unblocked scan's, and the whole result JAX's ms_dense_heads_parallel."""
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, reflen)
    x, sx = _build(tmp_path, ref, [mutate(rng, ref, snp)
                                   for _ in range(ndocs)])
    par = TP.ms_dense_heads_parallel(x, sx, block, 64, devices=CPUS)
    _assert_device_heads(TD.ms_dense_heads_on_device(x, sx, "cpu"), par)
    assert len(jax.local_devices()) == 8
    _assert_result(jax_par(x, sx, block_chars=block, ctx_chars=64), par)


def test_parallel_exact_copy_retries(tmp_path, capfd):
    """tests/test_parallel_blocked.py's twin: identical copies make every
    block retry with a doubled context."""
    rng = np.random.default_rng(3)
    ref = random_dna(rng, 300)
    d = mutate(rng, ref, 0.0)
    x, sx = _build(tmp_path, ref, [d, d, d])
    capfd.readouterr()
    par = TP.ms_dense_heads_parallel(x, sx, 120, 16, devices=CPUS)
    assert "context overflow" in capfd.readouterr().err
    _assert_device_heads(TD.ms_dense_heads_on_device(x, sx, "cpu"), par)
    _assert_result(jax_par(x, sx, block_chars=120, ctx_chars=16), par)


def _layout(layout: str, sn: int):
    return {"two": (-(-sn // 2), 64), "many": (max(sn // 7, 16), 64),
            "retry": (max(sn // 7, 16) + 3, 4)}[layout]


@pytest.mark.parametrize("layout", ["two", "many", "retry"])
@pytest.mark.parametrize("cid", CASE_IDS)
def test_parallel_matches_jax_and_sequential(cid, layout):
    """Field for field JAX's ms_dense_heads_parallel, and the port's
    sequential blocked loop's heads and reference index in the same
    blocks."""
    x, sx = case_collection(dict(zip(CASE_IDS, CASES))[cid])
    block, ctx = _layout(layout, len(sx))
    got = TP.ms_dense_heads_parallel(x, sx, block, ctx, devices=CPUS)
    _assert_result(jax_par(x, sx, block_chars=block, ctx_chars=ctx), got)
    _assert_device_heads(
        TD.ms_dense_heads_blocked_on_device(x, sx, "cpu", block, ctx), got)


def test_distinct_devices_raise(monkeypatch):
    """Blocks over more than one device, refused until it was ported, are
    the mesh scan's: two cards run it on two ranks (here gloo ranks on the
    CPU, the ranks' device monkeypatched), field for field JAX's
    ms_dense_heads_parallel; devices other than cuda:0..R-1 raise."""
    from cmsbwt_tpu_torch.parallel import distributed
    seen = []
    real = distributed.run

    def on_cpu(fn, inputs, device, n_devices=None):
        seen.append((str(device), n_devices))
        return real(fn, inputs, "cpu", n_devices)
    monkeypatch.setattr(distributed, "run", on_cpu)
    x, sx = case_collection(CASES[0])
    got = TP.ms_dense_heads_parallel(x, sx, 1000, 64,
                                     devices=["cuda:1", "cuda:0"])
    assert seen == [("cuda", 2)]
    _assert_result(jax_par(x, sx, block_chars=1000, ctx_chars=64), got)
    with pytest.raises(ValueError, match="cuda:0"):
        TP.ms_dense_heads_parallel(x, sx, 1000, 64, devices=["cpu", "meta"])


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("block", [None, 700], ids=["per_device", "700"])
def test_parallel_cli_matches_jax_cli(tmp_path, block, rle):
    """--parallel through both CLIs (JAX's runs its mesh program over 8
    virtual devices, the port its blocks on one device): equal bytes and
    debug artifact."""
    rng = np.random.default_rng(0)
    ref = random_dna(rng, 600)
    lst, _, _ = make_inputs(tmp_path, ref,
                            [mutate(rng, ref, 0.01) for _ in range(4)])
    flags = ["--backend", "dense", "--parallel", *(["-r"] if rle else []),
             *(["--block-chars", str(block)] if block else [])]
    assert cli.main([str(lst), "-o", str(tmp_path / "t"), "--device", "cpu",
                     *flags]) == 0
    assert jax_cli.main([str(lst), "-o", str(tmp_path / "j"), *flags]) == 0
    ext = ".rl_bwt" if rle else ".bwt"
    for e in (ext, ".counterSmallerThanHead_true"):
        assert (tmp_path / ("t" + e)).read_bytes() == \
            (tmp_path / ("j" + e)).read_bytes(), e
    assert "backend: dense" in (tmp_path / "t.log").read_text()


# --- checkpoints across the two loops and the two packages ---------------

FP = "fingerprint"


def _write(who: str, x, sx, block: int, ctx: int, d: str):
    """A checkpointed scan by one of the four loops, saving its blocks."""
    if who == "jax_parallel":
        return jax_par(x, sx, block_chars=block, ctx_chars=ctx,
                       checkpoint_dir=d, fingerprint=FP)
    if who == "jax_sequential":
        return MD.ms_dense_heads_blocked(x, sx, block_chars=block,
                                         ctx_chars=ctx, checkpoint_dir=d,
                                         fingerprint=FP)
    if who == "port_parallel":
        return TP.ms_dense_heads_parallel(x, sx, block, ctx, devices=CPUS,
                                          checkpoint_dir=d, fingerprint=FP)
    return download_heads_result(TD.ms_dense_heads_blocked_on_device(
        x, sx, "cpu", block, ctx, TD.BlockCheckpoints(d, FP, block)),
        len(x))


def _no_scan(monkeypatch, side: str):
    def scanned(*a, **k):
        raise AssertionError("the resuming run scanned")
    if side == "jax":
        monkeypatch.setattr(MD, "_joint_sa", scanned)
    else:
        monkeypatch.setattr(TD, "_scan_block", scanned)


LOOPS = ["port_parallel", "port_sequential", "jax_parallel",
         "jax_sequential"]


@pytest.mark.parametrize("reader", LOOPS)
@pytest.mark.parametrize("writer", LOOPS)
def test_block_checkpoints_resume_across_loops(tmp_path, monkeypatch, writer,
                                               reader):
    """Block files one loop saved (JAX's parallel loop before the head
    fixup, the others chained) are loaded by every other loop with no
    scan. The port's loops give the fresh scan's heads from any of them;
    so do the JAX loops, except the JAX sequential loop on files JAX's
    parallel loop saved (test_jax_sequential_resume_of_parallel_blocks)."""
    x, sx = case_collection(CASES[1])            # lowdiv
    block, ctx = -(-len(sx) // 3), 64
    d = str(tmp_path / "ck")
    fresh = MD.ms_dense_heads_blocked(x, sx, block_chars=block,
                                      ctx_chars=ctx)
    _write(writer, x, sx, block, ctx, d)
    assert len(os.listdir(d)) == 3
    _no_scan(monkeypatch, reader.split("_")[0])
    got = _write(reader, x, sx, block, ctx, d)
    if reader == "jax_sequential" and writer == "jax_parallel":
        assert got.h > fresh.h        # the reference's fault, kept as is
        return
    _assert_result(fresh, got, FIELDS[:5])


def test_jax_sequential_resume_of_parallel_blocks():
    """The JAX package's own resume differs: its sequential loop loads
    blocks its parallel loop saved before the fixup without chaining them,
    so every block whose first position continues the previous block's
    match keeps a spurious head, and on this input (CASES[1], three
    blocks) the BWT's runs differ too. The port's sequential loop chains
    them and gives the fresh scan's heads."""
    import tempfile
    x, sx = case_collection(CASES[1])
    block, ctx = -(-len(sx) // 3), 64
    fresh = MD.ms_dense_heads_blocked(x, sx, block_chars=block,
                                      ctx_chars=ctx)
    with tempfile.TemporaryDirectory() as d:
        jax_par(x, sx, block_chars=block, ctx_chars=ctx, checkpoint_dir=d,
                fingerprint=FP)
        resumed = MD.ms_dense_heads_blocked(
            x, sx, block_chars=block, ctx_chars=ctx, checkpoint_dir=d,
            fingerprint=FP)
        port = TD.ms_dense_heads_blocked_on_device(
            x, sx, "cpu", block, ctx, TD.BlockCheckpoints(d, FP, block),
            to_host=True)
    assert (fresh.h, resumed.h) == (24, 26)
    first = int(np.nonzero(resumed.head_t[:fresh.h] != fresh.head_t)[0][0])
    assert resumed.head_t[first] in (block, 2 * block)   # a block's start
    ndoc = int((sx == jfasta.SEPARATOR).sum()) + 1
    runs = [JM.merge_heads_numpy(
        r.head_t, r.head_pos, r.head_len, r.head_smaller, r.head_char,
        r.ref_sa, r.ref_isa, r.ref_bwt, r.h, len(x), r.sn, ndoc, False)
        for r in (fresh, resumed, port)]
    assert not np.array_equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0], runs[2]):
        np.testing.assert_array_equal(a, b)
    _assert_result(fresh, port, FIELDS[:5])
