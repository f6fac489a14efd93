"""The device writer (cmsbwt_tpu_torch/io/output.py): the .rl_bwt records
and the .bwt bytes made from the device merge's run list where it lies,
then copied into the file.

On the CPU ``rle_pack`` and ``bwt_expand`` run their plain versions
(``rle_pack_reference``, ``bwt_expand_reference``); the CUDA kernels
(kernels/csrc/run_output.cu) are held to them on the card by
chip_smoke.py. Here the plain versions are held to the JAX package's
writers (engine/merge.runs_to_rle, runs_to_plain) on the runs of the JAX
device merge of every tests/torch_cases.CASES collection, in both RLE
modes, and on made merged run lists (hypothesis: R = 0 and 1, a leading
char-0 run, runs longer than a kernel tile, R at the kernels' tile sizes
+- 1); the faults (an unmerged list, a length of 0, lengths that do not
sum to sn) raise and write no file; the CLI on --device cpu writes
through this path bytes equal to the JAX CLI's, with no run array
downloaded; CMSBWT.transform's bytes on this path equal the JAX model's;
encode_runs's one host copy, native or by ctypes.memmove, gives a new
bytes object equal to the JAX writers' at every chunking.
Tolerance: exact bytes."""
from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from helpers import make_inputs, mutate, random_dna
from torch_cases import CASE_IDS, CASES, carry_heads, case_collection
from cmsbwt_tpu import cli as jax_cli
from cmsbwt_tpu.engine import device_merge as jm
from cmsbwt_tpu.engine.merge import runs_to_plain, runs_to_rle
from cmsbwt_tpu.models.cms_bwt import CMSBWT as JaxCMSBWT
from cmsbwt_tpu.ops.ms_jump import ms_jump_heads
from cmsbwt_tpu_torch import CMSBWT
from cmsbwt_tpu_torch.cli import main as port_main
from cmsbwt_tpu_torch.config import Config
from cmsbwt_tpu_torch.engine import device_merge as tm
from cmsbwt_tpu_torch.engine import pipeline as tp
from cmsbwt_tpu_torch.io import native, output
from cmsbwt_tpu_torch.utils import timing

torch.set_num_threads(1)

# run_output.cu's tiles: records a pack block, runs a scan tile, output
# bytes an expand block
PACK_TILE, ENDS_TILE, EXP_TILE = 512, 4096, 16384
CHARS = np.array([2, 65, 67, 71, 84], np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_heads(case_idx):
    x_aug, sx = case_collection(CASES[case_idx])
    res = ms_jump_heads(x_aug, sx, lanes=4, window=16)
    return res, int((sx == 2).sum()) + 1


def _as_torch(run_len, run_char):
    return (torch.from_numpy(np.asarray(run_len).astype(np.int32)),
            torch.from_numpy(np.asarray(run_char).astype(np.uint8)))


@pytest.mark.parametrize("rle_quirk", [False, True])
@pytest.mark.parametrize("case_idx", range(len(CASES)), ids=CASE_IDS)
def test_plain_versions_match_jax_writers(case_idx, rle_quirk):
    """The JAX device merge's runs: rle_pack_reference gives runs_to_rle's
    records and bwt_expand_reference runs_to_plain's bytes (the plain
    .bwt: sn chars without the quirk); the port's merge, whose runs stay
    on its device, gives the same runs, and the dispatch the same
    bytes."""
    jres, d = _jax_heads(case_idx)
    rl, rc, _ = jm.merge_heads_device_resident(jres, d, rle_quirk,
                                               want_counter=False)
    rl, rc = np.asarray(rl), np.asarray(rc)
    t_len, t_chr = _as_torch(rl, rc)
    sn = int(rl.sum())
    if not rle_quirk:
        assert sn == jres.sn
    packed, fault = output.rle_pack_reference(t_len, t_chr)
    assert int(fault[0]) == 0
    assert packed.numpy().tobytes() == runs_to_rle(rl, rc)
    plain, fault = output.bwt_expand_reference(t_len, t_chr, sn)
    assert int(fault[0]) == 0
    assert plain.numpy().tobytes() == runs_to_plain(rl, rc)
    g_len, g_chr, _ = tm.merge_heads_device_resident(
        carry_heads(jres), d, rle_quirk, want_counter=False)
    assert g_len.dtype == torch.int32 and g_chr.dtype == torch.uint8
    assert torch.equal(g_len, t_len) and torch.equal(g_chr, t_chr)
    assert output.rle_pack(g_len, g_chr).numpy().tobytes() == \
        runs_to_rle(rl, rc)
    assert output.bwt_expand(g_len, g_chr, sn).numpy().tobytes() == \
        runs_to_plain(rl, rc)


def _made_runs(R, seed, lead0=False, long_every=0):
    rng = np.random.default_rng(seed)
    ln = rng.integers(1, 13, R).astype(np.int64)
    if long_every:
        ln[::long_every] = 3 * EXP_TILE + 5
    ch = CHARS[np.cumsum(rng.integers(1, len(CHARS), R)) % len(CHARS)]
    if lead0 and R:
        ch[0] = 0
    return ln, ch


def _check_made(ln, ch):
    t_len, t_chr = _as_torch(ln, ch)
    sn = int(ln.sum())
    want_rle = runs_to_rle(ln, ch)
    assert output.rle_pack(t_len, t_chr).numpy().tobytes() == want_rle
    assert output.rle_pack_reference(t_len, t_chr)[0].numpy().tobytes() == \
        want_rle
    assert output.bwt_expand(t_len, t_chr, sn).numpy().tobytes() == \
        runs_to_plain(ln, ch)
    # the records decode to the runs
    rec = np.frombuffer(want_rle, dtype=[("len", "<u8"), ("chr", "u1")])
    if len(ln):
        assert np.array_equal(rec["len"], ln) and \
            np.array_equal(rec["chr"], ch)
    else:
        assert len(rec) == 1 and rec["len"][0] == 0 and rec["chr"][0] == 0


@pytest.mark.parametrize("R", [0, 1, 2, PACK_TILE - 1, PACK_TILE,
                               PACK_TILE + 1, 3 * PACK_TILE + 5,
                               ENDS_TILE - 1, ENDS_TILE, ENDS_TILE + 1])
def test_made_runs_at_tile_sizes(R):
    _check_made(*_made_runs(R, R))


@pytest.mark.parametrize("kind", ["lead0", "long_runs", "one_long"])
def test_made_runs_edges(kind):
    """A leading char-0 run is one record (the tool's prevChar = 0 start
    merges nothing into it); runs longer than an expand tile."""
    if kind == "lead0":
        ln, ch = _made_runs(700, 3, lead0=True)
        assert ch[0] == 0
    elif kind == "long_runs":
        ln, ch = _made_runs(300, 4, long_every=7)
    else:
        ln, ch = np.array([5 * EXP_TILE + 3]), np.array([0], np.uint8)
    _check_made(ln, ch)


@settings(max_examples=60, deadline=None)
@given(R=st.integers(0, 3 * PACK_TILE), seed=st.integers(0, 2**16),
       lead0=st.booleans(), long_every=st.sampled_from([0, 1, 5, 64]))
def test_made_runs_hypothesis(R, seed, lead0, long_every):
    _check_made(*_made_runs(R, seed, lead0, long_every))


def test_faults_raise(tmp_path):
    """An unmerged list (two neighbours of one char), a length of 0 and
    lengths that do not sum to sn: the plain versions set the kernel's
    fault bits, the dispatch raises, and the writer leaves no file."""
    ln, ch = _made_runs(2000, 9)
    t_len, t_chr = _as_torch(ln, ch)
    sn = int(ln.sum())
    dup = t_chr.clone()
    dup[700] = dup[699]
    assert int(output.rle_pack_reference(t_len, dup)[1][0]) == \
        output.CHAR_FAULT
    with pytest.raises(RuntimeError, match="same char"):
        output.rle_pack(t_len, dup)
    zero = t_len.clone()
    zero[1000] = 0
    assert int(output.rle_pack_reference(zero, t_chr)[1][0]) == \
        output.LEN_FAULT
    with pytest.raises(RuntimeError, match="not positive"):
        output.rle_pack(zero, t_chr)
    with pytest.raises(RuntimeError, match="not positive"):
        output.bwt_expand(zero, t_chr, sn - int(ln[1000]))
    for n in (sn - 1, sn + 1):
        assert int(output.bwt_expand_reference(t_len, t_chr, n)[1][0]) == \
            output.SUM_FAULT
        with pytest.raises(RuntimeError, match="do not sum"):
            output.bwt_expand(t_len, t_chr, n)
    path = tmp_path / "x.rl_bwt"
    with pytest.raises(RuntimeError):
        output.write_runs(str(path), t_len, dup, rle=True, sn=sn)
    assert not path.exists()
    with pytest.raises(RuntimeError):
        output.bwt_expand(t_len[:0], t_chr[:0], 5)


def test_copy_out_chunks(tmp_path, monkeypatch):
    """copy_out hands a buffer over in STAGE_BYTES chunks, in order; the
    written file holds the bytes."""
    monkeypatch.setattr(output, "STAGE_BYTES", 1000)
    ln, ch = _made_runs(1500, 5)
    t_len, t_chr = _as_torch(ln, ch)
    sizes = []
    buf = output.rle_pack(t_len, t_chr)
    assert output.copy_out(buf, lambda m: sizes.append(len(m))) == 9 * 1500
    assert sizes == [1000] * 13 + [500]
    path = tmp_path / "x.bwt"
    n = output.write_runs(str(path), t_len, t_chr, rle=False,
                          sn=int(ln.sum()))
    assert n == int(ln.sum()) and path.read_bytes() == runs_to_plain(ln, ch)
    assert output.LAST_WRITE["runs"] == 1500 and \
        output.LAST_WRITE["bytes"] == n
    assert output.encode_runs(t_len, t_chr, rle=True, sn=n) == \
        runs_to_rle(ln, ch)


def _vm_flags(addr):
    """The VmFlags of this process's mapping that holds ``addr``."""
    lo = None
    for line in open("/proc/self/smaps"):
        head = line.split()[0]
        if "-" in head and ":" not in head:
            a, b = (int(x, 16) for x in head.split("-"))
            lo = a <= addr < b
        elif lo and head == "VmFlags:":
            return line.split()[1:]
    return None


@pytest.fixture(params=["native", "memmove"])
def copy_route(request, monkeypatch):
    """encode_runs's copy into its result: the native library's threads, or
    ctypes.memmove with the library made unavailable."""
    if request.param == "memmove":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, "the native library did not build"
    return request.param


@pytest.mark.parametrize("rle,R,stage", [
    (True, 1000, 1000),          # 9 000 bytes: 9 whole chunks
    (True, 1001, 1000),          # 9 009 bytes: a short last chunk
    (True, 0, 1000),             # R = 0: the single (0, 0) record
    (False, 700, 1000),          # the .bwt, a short last chunk
    (True, 600_000, 1 << 20),    # 5.4 MB: whole huge pages of the result
    (False, 900_000, 1 << 20),   # the .bwt, 5.8 MB
], ids=["rle_exact", "rle_ragged", "rle_one_record", "plain_ragged",
        "rle_above_huge", "plain_above_huge"])
def test_encode_runs_one_copy_into_bytes(monkeypatch, copy_route, rle, R,
                                         stage):
    """encode_runs returns a bytes object equal byte for byte to the JAX
    writers' (runs_to_rle / runs_to_plain) at every chunking, by either
    copy; the native copy runs result_threads threads (several here: a
    small RESULT_SLICE), counted in encode.result.threads, and advises the
    result's aligned interior into huge pages where the host has them."""
    monkeypatch.setattr(output, "STAGE_BYTES", stage)
    monkeypatch.setattr(output, "RESULT_SLICE", 64)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(8)))
    ln, ch = _made_runs(R, R + 3)
    t_len, t_chr = _as_torch(ln, ch)
    timing.reset()
    out = output.encode_runs(t_len, t_chr, rle=rle, sn=int(ln.sum()))
    assert type(out) is bytes
    assert out == (runs_to_rle(ln, ch) if rle else runs_to_plain(ln, ch))
    threads = timing.COUNTS["encode.result.threads"]
    assert threads == ((1 if R == 0 else output.RESULT_MAX_THREADS)
                       if copy_route == "native" else 0)
    huge = 2 << 20
    base = output._bytes_at(out)
    interior = (base + huge - 1) // huge * huge
    if (copy_route == "native" and interior + huge <= base + len(out) and
            os.path.exists("/sys/kernel/mm/transparent_hugepage/enabled")):
        assert "hg" in _vm_flags(interior)


def test_encode_runs_returns_a_new_object_each_call(copy_route):
    """Two calls in a row give two distinct bytes objects, and the second
    leaves the first as it was: nothing is pooled between calls."""
    ln, ch = _made_runs(5000, 1)
    ln2 = np.roll(ln, 7)
    ch2 = CHARS[(np.searchsorted(CHARS, ch) + 1) % len(CHARS)]
    first = output.encode_runs(*_as_torch(ln, ch), rle=True,
                               sn=int(ln.sum()))
    second = output.encode_runs(*_as_torch(ln2, ch2), rle=True,
                                sn=int(ln2.sum()))
    assert first is not second and len(first) == len(second)
    assert first == runs_to_rle(ln, ch)
    assert second == runs_to_rle(ln2, ch2) != first


@pytest.mark.parametrize("cpus,chunk,want", [
    (8, 16 << 20, 4),        # the 16 MiB chunk on an 8-CPU host: the cap
    (2, 16 << 20, 2),        # fewer CPUs than the cap
    (8, 5 << 20, 2),         # a chunk of two whole huge pages
    (8, 1000, 1),            # a small chunk: one thread
])
def test_result_threads_follow_cpus_and_chunk(monkeypatch, cpus, chunk,
                                              want):
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cpus)))
    assert output.result_threads(chunk) == want


def test_pipeline_result_downloads_when_read():
    """A result holding device runs gives numpy arrays (run_len int64) at
    its first read, downloaded once."""
    ln, ch = _made_runs(100, 6)
    t_len, t_chr = _as_torch(ln, ch)
    before = tm.RUN_DOWNLOADS[0]
    res = tp.PipelineResult(d=1, sn=int(ln.sum()), h=3,
                            device_runs=(t_len, t_chr))
    assert tm.RUN_DOWNLOADS[0] == before
    assert res.run_len.dtype == np.int64 and np.array_equal(res.run_len, ln)
    assert np.array_equal(res.run_char, ch) and res.run_char.dtype == np.uint8
    assert tm.RUN_DOWNLOADS[0] == before + 1
    host = tp.PipelineResult(run_len=ln, run_char=ch, d=1, sn=5, h=2)
    assert host.device_runs is None and host.run_len is ln


def _inputs(tmp_path, seed=11):
    rng = np.random.default_rng(seed)
    ref = random_dna(rng, 500)
    docs = [mutate(rng, ref, 0.01) for _ in range(4)]
    docs.append(docs[1])    # a duplicate document: exact pairs
    lst, _, _ = make_inputs(tmp_path, ref, docs)
    return ref, lst


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend,merge", [
    ("jump", "auto"), ("jump", "device"), ("dense", "device")])
def test_cli_device_writer_matches_jax_cli(tmp_path, backend, merge, rle):
    """The CLI with the device merge on --device cpu (auto takes it after
    the jump scan there) writes through the device writer (the plain
    versions, no run array downloaded): bytes equal to the JAX CLI's (its
    device merge)."""
    _, lst = _inputs(tmp_path)
    fmt = ["-r"] if rle else []
    ext = ".rl_bwt" if rle else ".bwt"
    be = ["--backend", backend]
    merge = ["--merge-backend", merge]
    calls = dict(output.REFERENCE_CALLS)
    downloads = tm.RUN_DOWNLOADS[0]
    output.LAST_WRITE.clear()
    assert port_main([str(lst), "-o", str(tmp_path / "port"), "--device",
                      "cpu", "--lanes", "8", *be, *merge, *fmt]) == 0
    assert jax_cli.main([str(lst), "-o", str(tmp_path / "jax"), *be,
                         "--lanes", "8", "--merge-backend", "device",
                         *fmt]) == 0
    port = (tmp_path / ("port" + ext)).read_bytes()
    assert len(port) > 0 and port == (tmp_path / ("jax" + ext)).read_bytes()
    name = "rle_pack_reference" if rle else "bwt_expand_reference"
    assert output.REFERENCE_CALLS[name] == calls[name] + 1
    assert tm.RUN_DOWNLOADS[0] == downloads
    assert output.LAST_WRITE["bytes"] == len(port)
    log = (tmp_path / "port.log").read_text()
    assert "\nmerge_device: " in log and "\nwrite_output: " in log


@pytest.mark.parametrize("rle", [False, True], ids=["plain", "rle"])
@pytest.mark.parametrize("backend,merge", [
    ("jump", "auto"), ("jump", "device"), ("dense", "device")])
def test_transform_device_writer_matches_jax(tmp_path, backend, merge, rle):
    """CMSBWT.transform after the device merge (auto on the CPU for jump,
    or merge_backend 'device') encodes through the device writer: the JAX
    model's bytes, the merge_device and encode phases, no run array
    downloaded."""
    ref, lst = _inputs(tmp_path, 12)
    coll = lst.read_text().split()[1]
    cfg = Config(lanes=8, skip_window=16, merge_backend=merge)
    want = JaxCMSBWT(ref, Config(lanes=8, skip_window=16)).transform(
        coll, rle=rle, backend=backend)
    downloads = tm.RUN_DOWNLOADS[0]
    got = CMSBWT(ref, cfg, device="cpu").transform(coll, rle=rle,
                                                  backend=backend)
    assert (got.bwt, got.rle, got.sn, got.heads) == \
        (want.bwt, want.rle, want.sn, want.heads)
    phases = [k for k, _ in got.timer.phases]
    assert phases == ["ms_scan", "merge_device", "encode"]
    assert tm.RUN_DOWNLOADS[0] == downloads
