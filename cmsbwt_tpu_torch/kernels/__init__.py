"""Hand-written CUDA kernels of the port: build, load and launch.

Each kernel lives in ``csrc/`` as CUDA C++ for Hopper (sm_90a) with a plain
C entry point; the scans share ``csrc/tile_scan.cuh``.
``load()`` compiles each source with its own ``nvcc`` process, all at
once, into a shared library per source at first use (into ``build/``
beside this file, or ``$CMSBWT_TORCH_BUILD_DIR``; each file name carries a
hash of its source, the shared headers and the flags, so an edited source
rebuilds) and binds them with ctypes. A build or launch failure raises;
nothing falls back to a plain version.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show it went through
the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("ms_jump_scan.cu", "lcp_lift.cu", "dense_neighbors.cu",
           "running_fill.cu", "tail_good_join.cu", "run_merge.cu",
           "tail_exact_credit.cu", "radix_sort.cu", "compact.cu",
           "sa_round.cu", "pair_expand.cu", "run_output.cu")
# the largest group a compacted round of the head string's suffix sort
# sorts in shared memory, and the largest slice its tail runs in one block
# (sa_round.cu's C_CAP, passed to every build; index/device.COMP_CAP)
COMP_CAP = 4096
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              f"-DCOMP_CAP={COMP_CAP}"]
LIFT_THREADS = 256

LAUNCHES = {"ms_jump_scan": 0, "lcp_lift": 0, "dense_neighbors": 0,
            "running_fill": 0, "tail_good_join": 0, "bucket_sums": 0,
            "run_merge": 0, "tail_exact_credit": 0, "radix_hist": 0,
            "radix_pass": 0, "compact": 0, "sa_round": 0, "dense_rank": 0,
            "dense_rank_comp": 0, "pair_expand": 0, "rle_pack": 0,
            "bwt_expand": 0}
BUILD = {"seconds": None, "path": None, "log": ""}

_lock = threading.Lock()
_libs = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _build_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get(
        "CMSBWT_TORCH_BUILD_DIR",
        pathlib.Path(__file__).resolve().parent / "build"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME, "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def bind_radix_sort(lib) -> None:
    """Set the ctypes signatures of a radix_sort.cu library (this tree's,
    or a variant tools/radix_variants.py builds)."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for k in ("radix_sort_max_passes", "radix_sort_radix_bits",
              "radix_sort_tile"):
        getattr(lib, k).restype = I
        getattr(lib, k).argtypes = []
    lib.radix_pass_blocks_per_sm.restype = I
    lib.radix_pass_blocks_per_sm.argtypes = [I, I, I, I]
    lib.radix_sort_scratch_bytes.restype = LL
    lib.radix_sort_scratch_bytes.argtypes = [LL]
    lib.radix_sort_run.restype = I
    IP = ctypes.POINTER(I)
    lib.radix_sort_run.argtypes = [
        I, ctypes.POINTER(P), IP, ctypes.POINTER(LL), IP, IP, I, IP, IP, IP,
        I, I, I, P, P, P, P, P, P, LL, P, P, P]


def _bind(libs: dict) -> None:
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = libs["ms_jump_scan"].ms_jump_scan_launch
    f.restype = I
    f.argtypes = [P, LL, P, P, P, P, ctypes.POINTER(I), I, I, P, I, I, P, I,
                  I] + [P] * 13 + [P]
    f = libs["lcp_lift"].lcp_lift_launch
    f.restype = I
    f.argtypes = [P, P, I, P, P, P, P, I, I, I, I, I, P]
    f = libs["dense_neighbors"].dense_neighbors_scratch_bytes
    f.restype = LL
    f.argtypes = [I]
    f = libs["dense_neighbors"].dense_neighbors_launch
    f.restype = I
    f.argtypes = [P, P, I, I, P, P, P, P, P, P]
    f = libs["running_fill"].running_fill_scratch_bytes
    f.restype = LL
    f.argtypes = [LL, I]
    f = libs["running_fill"].running_fill_launch
    f.restype = I
    f.argtypes = [P, P, LL, I, I, I, P, P]
    f = libs["tail_good_join"].tail_good_join_scratch_bytes
    f.restype = LL
    f.argtypes = [I]
    f = libs["tail_good_join"].tail_good_join_launch
    f.restype = I
    f.argtypes = [P, P, P, P, I, P, P, P, I, P, P, P]
    for k in ("run_merge_scratch_bytes", "bucket_sums_scratch_bytes"):
        f = getattr(libs["run_merge"], k)
        f.restype = LL
        f.argtypes = [I]
    for k in ("run_merge_count_offset", "bucket_sums_fault_offset"):
        f = getattr(libs["run_merge"], k)
        f.restype = LL
        f.argtypes = []
    f = libs["run_merge"].bucket_sums_launch
    f.restype = I
    f.argtypes = [P, P, P, I, I, I, P, P, P, P, P]
    f = libs["run_merge"].run_merge_launch
    f.restype = I
    f.argtypes = [P, P, P, I, P, P, P, P]
    f = libs["tail_exact_credit"].tail_exact_credit_launch
    f.restype = I
    f.argtypes = [P, P, P, I, P, I, P, P, P, P, I, P, I, P]
    bind_radix_sort(libs["radix_sort"])
    lib = libs["compact"]
    lib.compact_scratch_bytes.restype = LL
    lib.compact_scratch_bytes.argtypes = [LL]
    lib.compact_launch.restype = I
    lib.compact_launch.argtypes = [P, LL, LL, P, P, P, P]
    lib = libs["sa_round"]
    lib.sa_round_scratch_bytes.restype = LL
    lib.sa_round_scratch_bytes.argtypes = [LL, I, I]
    lib.sa_round_count_offset.restype = LL
    lib.sa_round_count_offset.argtypes = []
    lib.sa_round_pack_launch.restype = I
    lib.sa_round_pack_launch.argtypes = [I] + [P] * 5 + [I, P]
    lib.sa_round_launch.restype = I
    lib.sa_round_launch.argtypes = [I] + [P] * 14 + [I, I, I, I, P, P]
    lib.dense_rank_launch.restype = I
    lib.dense_rank_launch.argtypes = [I] + [P] * 5 + [LL] + [P] * 3 + [
        I, P, P, I, I, P, P, P]
    lib.dense_rank_comp_scratch_bytes.restype = LL
    lib.dense_rank_comp_scratch_bytes.argtypes = [LL]
    lib.dense_rank_comp_tile.restype = I
    lib.dense_rank_comp_tile.argtypes = []
    lib.dense_rank_comp_small.restype = I
    lib.dense_rank_comp_small.argtypes = []
    lib.dense_rank_comp_pick_launch.restype = I
    lib.dense_rank_comp_pick_launch.argtypes = [P] * 3 + [I, I] + [P] * 6
    lib.dense_rank_comp_launch.restype = I
    lib.dense_rank_comp_launch.argtypes = [P] * 5 + [I, P, P, I, I, I] + [
        P] * 7 + [LL, P, P, P]
    lib.dense_rank_comp_tail_launch.restype = I
    lib.dense_rank_comp_tail_launch.argtypes = [P] * 4 + [I, P, P, I, I, LL,
                                                          I, P, P, P]
    lib = libs["pair_expand"]
    lib.pair_expand_launch.restype = I
    lib.pair_expand_launch.argtypes = [P] * 10 + [I, I, I, I, LL] + [P] * 6
    lib = libs["run_output"]
    lib.run_output_scratch_bytes.restype = LL
    lib.run_output_scratch_bytes.argtypes = [LL]
    lib.run_output_fault_offset.restype = LL
    lib.run_output_fault_offset.argtypes = []
    lib.rle_pack_launch.restype = I
    lib.rle_pack_launch.argtypes = [P, P, LL, P, P, P]
    lib.bwt_expand_launch.restype = I
    lib.bwt_expand_launch.argtypes = [P, P, LL, LL, P, P, P, P]


def load() -> dict:
    """Build (first use) and load the kernel libraries, one shared library
    per source, all compiled at once by parallel nvcc processes; returns
    {kernel name: ctypes handle}. ``BUILD`` records the build time and
    the compilers' logs."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        t0 = time.perf_counter()
        nvcc, bdir = None, _build_dir()
        sos, jobs = {}, []
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC.glob("*.cuh")))
        for s in SOURCES:
            src = CSRC / s
            digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
            digest.update(headers)
            digest.update(src.read_bytes())
            so = bdir / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"
            sos[src.stem] = so
            if not so.exists():
                nvcc = nvcc or _nvcc()
                tmp = so.with_name(f".{so.name}.{os.getpid()}")
                jobs.append((src, so, tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        logs, failed = [], []
        for src, so, tmp, proc in jobs:   # wait for every build
            out = proc.communicate()[0]
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(src.name)
            else:
                os.replace(tmp, so)
        BUILD["log"] = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + BUILD["log"])
        libs = {k: ctypes.CDLL(str(so)) for k, so in sos.items()}
        _bind(libs)
        BUILD["seconds"] = time.perf_counter() - t0
        BUILD["path"] = str(bdir)
        _libs = libs
        return libs


def _ptr(a: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.data_ptr())


def _check(name, a, dtype, shape=None, device=None):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: expected a cuda tensor, got {a.device}")
    if device is not None and a.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{a.device}")
    if a.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(a.shape)}")


def _launch(name: str, err: int) -> None:
    """Raise on a launch that returned a CUDA error; else count it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def ms_jump_scan_cuda(x_padded, sa, isa, trees, sx_padded, state: dict,
                      chunk_ends, *, n: int, sn: int, cap: int,
                      window: int) -> dict:
    """Launch ``ms_jump_scan`` on CUDA tensors: every lane runs to the end
    of its chunk; ``state`` (see ops/ms_jump.jump_init_state) is updated in
    place and returned. ``trees`` is the ops/ms_jump.BlockTrees of the
    index. Same contract as ms_jump_scan_reference, which reads the sparse
    tables instead."""
    from ..ops.ms_jump import TREE_MAX_LEVELS, tree_geometry
    dev = chunk_ends.device
    L = int(chunk_ends.shape[0])
    i32, u8, b = torch.int32, torch.uint8, torch.bool
    offsets, _, size = tree_geometry(n)
    if trees.n != n or tuple(trees.offsets) != offsets \
            or len(offsets) > TREE_MAX_LEVELS:
        raise ValueError("ms_jump_scan: block trees of another geometry")
    _check("chunk_ends", chunk_ends, i32, (L,), dev)
    _check("x_padded", x_padded, u8, None, dev)
    _check("sa", sa, i32, (n,), dev)
    _check("isa", isa, i32, (n,), dev)
    _check("lcp tree", trees.lcp, i32, (size,), dev)
    _check("g tree", trees.g, i32, (size,), dev)
    _check("sx_padded", sx_padded, u8, (sn + window,), dev)
    for k in ("t", "length", "lb", "rb", "pos", "nrec"):
        _check(k, state[k], i32, (L,), dev)
    for k in ("fin", "done", "viol"):
        _check(k, state[k], b, (L,), dev)
    for k in ("out_t", "out_pos", "out_len"):
        _check(k, state[k], i32, (L, cap), dev)
    _check("out_sml", state["out_sml"], b, (L, cap), dev)
    if x_padded.shape[0] <= n or window < 1 or L < 1:
        raise ValueError("ms_jump_scan: bad geometry")
    lib = load()["ms_jump_scan"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ms_jump_scan_launch(
            _ptr(x_padded), x_padded.shape[0], _ptr(sa), _ptr(isa),
            _ptr(trees.lcp), _ptr(trees.g),
            (ctypes.c_int * len(offsets))(*offsets), len(offsets), n,
            _ptr(sx_padded), sn, window, _ptr(chunk_ends), L, cap,
            *(_ptr(state[k]) for k in ("t", "length", "lb", "rb", "pos",
                                       "fin", "done", "nrec", "viol",
                                       "out_t", "out_pos", "out_len",
                                       "out_sml")),
            ctypes.c_void_p(stream))
    _launch("ms_jump_scan", err)
    return state


def lcp_lift_cuda(hist, packs, ai, bi, lv, m: int,
                  lmax: int | None = None) -> torch.Tensor:
    """Launch ``lcp_lift`` on CUDA tensors: the lcp of each pair (ai, bi)
    by lifting from its split level lv through the rank history ``hist``
    [n_hist, m] and the seed ``packs`` [1 or 2, m]. Same contract as
    ops/joint_sa.lift_pairs; returns int32[len(ai)].

    ``lmax``, the largest lv of a valid row (ai, bi < m), sets the shared
    top level of the rows whose lv is below the seed level; for rows that
    all split at or above it any upper bound will do, such as the deepest
    level of the split-level histogram. Given, the wrapper neither reduces
    nor synchronises; else it computes lmax on the device and reads it
    back. No rows launch nothing."""
    from ..ops.joint_sa import seed_level_of
    dev = ai.device
    rows = int(ai.shape[0])
    i32 = torch.int32
    _check("ai", ai, i32, (rows,), dev)
    _check("bi", bi, i32, (rows,), dev)
    _check("lv", lv, i32, (rows,), dev)
    _check("hist", hist, i32, (int(hist.shape[0]), m), dev)
    _check("packs", packs, torch.int64, (int(packs.shape[0]), m), dev)
    if packs.shape[0] not in (1, 2) or m < 1:
        raise ValueError("lcp_lift: bad geometry")
    h = torch.empty(rows, dtype=i32, device=dev)
    if rows == 0:
        return h
    sl = seed_level_of(packs)
    if lmax is None:
        lmax = int(torch.where((ai < m) & (bi < m), lv, 0).max())
    if lmax - 2 - sl >= int(hist.shape[0]):
        raise ValueError("lcp_lift: split level beyond the rank history")
    lib = load()["lcp_lift"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lcp_lift_launch(
            _ptr(hist), _ptr(packs), int(packs.shape[0]), _ptr(ai),
            _ptr(bi), _ptr(lv), _ptr(h), rows, m, sl, int(lmax),
            LIFT_THREADS, ctypes.c_void_p(stream))
    _launch("lcp_lift", err)
    return h


def dense_neighbors_cuda(sa, ell, n: int, m: int):
    """Launch ``dense_neighbors`` on CUDA tensors sa, ell (int32[m]):
    returns (pred_pos, succ_pos, a, b), each int32[m]. Same contract as
    ops/ms_dense.neighbors_reference."""
    dev = sa.device
    i32 = torch.int32
    _check("sa", sa, i32, (m,), dev)
    _check("ell", ell, i32, (m,), dev)
    if m < 1:
        raise ValueError("dense_neighbors: empty input")
    if sa.data_ptr() % 16 or ell.data_ptr() % 16:
        raise ValueError("dense_neighbors: sa and ell must be 16-byte "
                         "aligned (the kernel loads them as int4)")
    lib = load()["dense_neighbors"]
    scratch = torch.empty(int(lib.dense_neighbors_scratch_bytes(m)),
                          dtype=torch.uint8, device=dev)
    outs = [torch.empty(m, dtype=i32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dense_neighbors_launch(
            _ptr(sa), _ptr(ell), n, m, _ptr(scratch), *map(_ptr, outs),
            ctypes.c_void_p(stream))
    _launch("dense_neighbors", err)
    return tuple(outs)


def running_fill_cuda(v: torch.Tensor, op: str = "max",
                      reverse: bool = False) -> torch.Tensor:
    """Launch ``running_fill`` on a 1-D int32 or int64 CUDA tensor: the
    inclusive running max (``op`` "max") or min ("min"), from the last row
    with ``reverse``. Same contract as ops/fill.running_fill_reference. An
    empty tensor launches nothing."""
    dev = v.device
    if v.dim() != 1 or v.dtype not in (torch.int32, torch.int64):
        raise ValueError("running_fill: expected a 1-D int32 or int64 "
                         f"tensor, got {v.dtype} of shape {tuple(v.shape)}")
    if op not in ("max", "min"):
        raise ValueError(f"running_fill: op must be 'max' or 'min', not "
                         f"{op!r}")
    if v.device.type == "cuda":
        v = v.contiguous()
    _check("v", v, v.dtype, None, dev)
    m = int(v.shape[0])
    out = torch.empty_like(v)
    if m == 0:
        return out
    lib = load()["running_fill"]
    elem = v.element_size()
    # the look-back's ticket and the tiles' states start at 0
    scratch = torch.zeros(int(lib.running_fill_scratch_bytes(m, elem)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.running_fill_launch(
            _ptr(v), _ptr(out), m, elem, int(op == "min"), int(reverse),
            _ptr(scratch), ctypes.c_void_p(stream))
    _launch("running_fill", err)
    return out


def tail_good_join_cuda(k1s, k2fs, i_s, pay_s, h_pad: int):
    """Launch ``tail_good_join`` on the join's sorted CUDA columns (k1s,
    i_s, pay_s int32[J]; k2fs int64[J], the target flag in bit 0):
    returns (counter int32[h_pad + 2], exact_key int32[J], f_cls int32[J],
    n_exact, exact_members). Same contract as
    engine/device_merge._tail_good_join_reference; reads the two counts
    back (one synchronisation)."""
    dev = k1s.device
    J = int(k1s.shape[0])
    i32 = torch.int32
    _check("k1s", k1s, i32, (J,), dev)
    _check("k2fs", k2fs, torch.int64, (J,), dev)
    _check("i_s", i_s, i32, (J,), dev)
    _check("pay_s", pay_s, i32, (J,), dev)
    if not 1 <= J < 2**31 - 1:
        raise ValueError(f"tail_good_join: {J} rows (1 <= J < 2^31 - 1)")
    lib = load()["tail_good_join"]
    counter = torch.zeros(h_pad + 2, dtype=i32, device=dev)
    exact_key = torch.empty(J, dtype=i32, device=dev)
    f_cls = torch.empty(J, dtype=i32, device=dev)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    # the look-back's ticket and flags start at 0
    scratch = torch.zeros(int(lib.tail_good_join_scratch_bytes(J)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tail_good_join_launch(
            _ptr(k1s), _ptr(k2fs), _ptr(i_s), _ptr(pay_s), J, _ptr(f_cls),
            _ptr(exact_key), _ptr(counter), h_pad + 2, _ptr(stats),
            _ptr(scratch), ctypes.c_void_p(stream))
    _launch("tail_good_join", err)
    n_exact, members = stats.tolist()
    return counter, exact_key, f_cls, n_exact, members


def run_merge_cuda(k_s, len_s, chr_s):
    """Launch ``run_merge`` on the lanes sorted by offset (CUDA int32[L]
    each): returns (run_len int32[n], run_char uint8[n], n), the merged
    groups compacted to the front. Same contract as
    engine/device_merge._run_merge_reference; reads n back (one
    synchronisation)."""
    dev = k_s.device
    L = int(k_s.shape[0])
    i32 = torch.int32
    _check("k_s", k_s, i32, (L,), dev)
    _check("len_s", len_s, i32, (L,), dev)
    _check("chr_s", chr_s, i32, (L,), dev)
    if not 1 <= L < 2**31 - 1:
        raise ValueError(f"run_merge: {L} lanes (1 <= L < 2^31 - 1)")
    lib = load()["run_merge"]
    out_len = torch.empty(L, dtype=i32, device=dev)
    out_chr = torch.empty(L, dtype=torch.uint8, device=dev)
    # the look-back's ticket and flags start at 0
    scratch = torch.zeros(int(lib.run_merge_scratch_bytes(L)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.run_merge_launch(
            _ptr(k_s), _ptr(len_s), _ptr(chr_s), L, _ptr(out_len),
            _ptr(out_chr), _ptr(scratch), ctypes.c_void_p(stream))
    _launch("run_merge", err)
    at = int(lib.run_merge_count_offset())
    n = int(scratch[at:at + 4].view(i32).item())
    return out_len[:n], out_chr[:n], n


def bucket_sums_cuda(bucket_rank, bid, m_c, nec: int, n_pad: int):
    """Launch ``bucket_sums`` on runs_emit's class lanes (CUDA int32[h_pad]
    each, in SA-walk order: the first ``nec`` valid, their bucket_rank
    never decreasing, bid their bucket's index, m_c 0 beyond them):
    returns (hb_at int32[n_pad],
    ncls_at int32[n_pad], hb_b int32[h_pad], fault int32[1]). Same
    contract as engine/device_merge._bucket_sums_reference; the caller
    reads ``fault`` (engine/device_merge.bucket_sums_check) after its next
    synchronisation: the wrapper itself does not synchronise."""
    dev = bucket_rank.device
    h_pad = int(bucket_rank.shape[0])
    i32 = torch.int32
    _check("bucket_rank", bucket_rank, i32, (h_pad,), dev)
    _check("bid", bid, i32, (h_pad,), dev)
    _check("m_c", m_c, i32, (h_pad,), dev)
    if not (1 <= h_pad <= 2**31 - 1 - 8192 and 1 <= n_pad <= 2**31 - 1
            - 8192 and nec <= h_pad):
        raise ValueError(f"bucket_sums: nec {nec}, h_pad {h_pad}, n_pad "
                         f"{n_pad}")
    lib = load()["run_merge"]
    # the kernel writes every slot of its outputs (zeros included)
    hb_at = torch.empty(n_pad, dtype=i32, device=dev)
    ncls_at = torch.empty(n_pad, dtype=i32, device=dev)
    hb_b = torch.empty(h_pad, dtype=i32, device=dev)
    # the look-back's ticket and flags, and the fault word, start at 0
    scratch = torch.zeros(int(lib.bucket_sums_scratch_bytes(nec)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.bucket_sums_launch(
            _ptr(bucket_rank), _ptr(bid), _ptr(m_c), nec, h_pad, n_pad,
            _ptr(hb_at), _ptr(ncls_at), _ptr(hb_b), _ptr(scratch),
            ctypes.c_void_p(stream))
    _launch("bucket_sums", err)
    at = int(lib.bucket_sums_fault_offset())
    return hb_at, ncls_at, hb_b, scratch[at:at + 4].view(i32)


def tail_exact_credit_cuda(counter_in, f_s, i_s, tgt, dst, tot: int,
                           cls_of_slot, slot_base, cls_hi, bucket_of_class,
                           h_pad: int):
    """Launch ``tail_exact_credit`` on the exact path's sorted join (CUDA
    int32 columns f_s, i_s and their reverse fill tgt; dst by query id;
    the class arrays of h_pad slots or more): returns counter_in (int32[
    h_pad + 2]) plus this path's credits. Same contract as
    engine/device_merge._exact_credit_reference."""
    dev = f_s.device
    J = int(f_s.shape[0])
    i32 = torch.int32
    _check("counter_in", counter_in, i32, (h_pad + 2,), dev)
    _check("f_s", f_s, i32, (J,), dev)
    _check("i_s", i_s, i32, (J,), dev)
    _check("tgt", tgt, i32, (J,), dev)
    _check("dst", dst, i32, None, dev)
    for name, a in (("cls_of_slot", cls_of_slot), ("slot_base", slot_base),
                    ("cls_hi", cls_hi),
                    ("bucket_of_class", bucket_of_class)):
        _check(name, a, i32, None, dev)
        if a.dim() != 1 or a.shape[0] < h_pad:
            raise ValueError(f"tail_exact_credit: {name} holds fewer than "
                             f"h_pad = {h_pad} slots")
    if dst.dim() != 1 or not 0 <= tot <= dst.shape[0]:
        raise ValueError("tail_exact_credit: tot exceeds the queries' dst")
    if not 1 <= J < 2**31 - 1 or h_pad < 1:
        raise ValueError(f"tail_exact_credit: {J} rows, h_pad {h_pad}")
    lib = load()["tail_exact_credit"]
    counter = counter_in.clone()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tail_exact_credit_launch(
            _ptr(f_s), _ptr(i_s), _ptr(tgt), J, _ptr(dst), tot,
            _ptr(cls_of_slot), _ptr(slot_base), _ptr(cls_hi),
            _ptr(bucket_of_class), h_pad, _ptr(counter), h_pad + 2,
            ctypes.c_void_p(stream))
    _launch("tail_exact_credit", err)
    return counter


def radix_offsets(bits) -> tuple:
    """Each key's lowest bit in the composite key (the last key's at 0)."""
    return tuple(sum(bits[q + 1:]) for q in range(len(bits)))


class RadixPass(NamedTuple):
    """One radix_pass launch of a sort (radix_plan). ``keys`` (key indices)
    and ``offs`` (their lowest bits in the composite): the pass reads
    those keys in place, composed (mode 1); empty: it reads the words the
    pass before wrote, u64 if ``in_wide``. The digit is at bit ``dshift``
    of its input; the staged word is the input >> ``drop`` (u64 if
    ``stage_wide``), written as the next pass's words if ``write``, as the
    first key's values if ``vals``; ``next``: the key whose words it
    writes, gathered through its rows. ``hist_src`` (-1: the composite,
    else a key) and ``hist_shift``: the same digit read from the keys
    themselves, where radix_hist counts the first pass's (each later
    pass's counts come from the pass before it, from the words it
    writes)."""
    keys: tuple
    offs: tuple
    in_wide: bool
    dshift: int
    drop: int
    stage_wide: bool
    write: bool
    vals: bool
    next: int | None
    hist_src: int
    hist_shift: int


def radix_plan(bits, radix_bits: int, values: bool = False) -> list:
    """The passes of a stable sort by keys of these widths (most
    significant first), in the order they run (RadixPass). When the keys'
    total width B less the first digit fits 64 bits: the composite plan,
    ceil(B / radix_bits) passes over the composite key C (the first key in
    its top bits), the first reading the keys in place, each writing C's
    words with the bits no later pass needs dropped (the first key's kept
    whole with ``values``). Otherwise the per-key plan: each key's digits
    in turn, the last key's first, its last pass writing the next key's
    words gathered through the rows."""
    rb = radix_bits
    bits = tuple(int(b) for b in bits)
    B = sum(bits)
    offs = radix_offsets(bits)
    keep = bits[0] if values else 0
    D = -(-B // rb)
    if D == 1 or B - min(rb, B - keep) <= 64:
        plan, dropped = [], 0
        for p in range(D):
            last = p + 1 == D
            if not last:
                out = min((p + 1) * rb, B - keep)
            else:
                out = B - bits[0] if values else dropped
            plan.append(RadixPass(
                keys=tuple(range(len(bits))) if p == 0 else (),
                offs=offs if p == 0 else (), in_wide=B - dropped > 32,
                dshift=p * rb - dropped, drop=out - dropped,
                stage_wide=B - out > 32 and (not last or values),
                write=not last, vals=last and values, next=None,
                hist_src=-1, hist_shift=p * rb))
            dropped = out
        return plan
    plan = []
    order = [(q, p) for q in reversed(range(len(bits)))
             for p in range(-(-bits[q] // rb))]
    for at, (q, p) in enumerate(order):
        final = at + 1 == len(order)
        last = final or order[at + 1][0] != q
        plan.append(RadixPass(
            keys=(q,) if at == 0 else (), offs=(0,) if at == 0 else (),
            in_wide=bits[q] > 32, dshift=p * rb, drop=0,
            stage_wide=bits[q] > 32 and (not last or (final and values)),
            write=not last, vals=final and values,
            next=None if final or not last else order[at + 1][0],
            hist_src=q, hist_shift=p * rb))
    return plan


@functools.lru_cache(maxsize=256)
def _radix_records(bits: tuple, rb: int, values: bool) -> tuple:
    """The plan of a sort (radix_plan) and its pass records as
    radix_sort_run reads them: ten ints a pass (in_wide, dshift, drop,
    stage_wide, write, vals, next key or -1, the next pass's dshift or
    -1, hist_src, hist_shift)."""
    plan = radix_plan(bits, rb, values)
    recs = []
    for at, ps in enumerate(plan):
        recs += [int(ps.in_wide), ps.dshift, ps.drop, int(ps.stage_wide),
                 int(ps.write), int(ps.vals),
                 -1 if ps.next is None else ps.next,
                 plan[at + 1].dshift if at + 1 < len(plan) else -1,
                 ps.hist_src, ps.hist_shift]
    return plan, tuple(recs)


class _RadixRun:
    """One sort's plan, buffers and C arguments on a radix_sort.cu library
    (radix_sort_cuda's, or a build tools/radix_variants.py times):
    ``run(a, b)`` launches steps [a, b) in one C call (step 0 radix_hist,
    step p + 1 pass p); ``result()`` the outputs once every step ran."""

    def __init__(self, lib, keys, bits, fault, values, scratch):
        from ..ops.sort import PADS
        dev, n = keys[0].device, int(keys[0].shape[0])
        plan, recs = _radix_records(bits, int(lib.radix_sort_radix_bits()),
                                    values)
        D = len(plan)
        if D > int(lib.radix_sort_max_passes()):
            raise ValueError(f"radix_sort: {D} passes (at most "
                             f"{int(lib.radix_sort_max_passes())})")
        # the passes' tickets, digit counts and the tiles' words start at 0
        size = int(lib.radix_sort_scratch_bytes(n))
        if scratch is None:
            scratch = torch.zeros(size, dtype=torch.uint8, device=dev)
        _check("scratch", scratch, torch.uint8, (size,), dev)
        # ping-pong buffers, from torch.empty (every row is written): pass
        # p writes its words (or the next key's) to words[p % 2], its row
        # ids to rows[p % 2]; the last pass writes no words, and its rows
        # go to the row buffer the passes before freed
        width = [0, 0]
        for p, ps in enumerate(plan):
            w = (8 if ps.stage_wide else 4) if ps.write else (
                0 if ps.next is None else 8 if bits[ps.next] > 32 else 4)
            width[p % 2] = max(width[p % 2], w)
        self.words = [torch.empty(n * w, dtype=torch.uint8, device=dev)
                      if w else None for w in width]
        rows = [torch.empty(n, dtype=torch.int32, device=dev)
                if any(p % 2 == k for p in range(D - 1)) else None
                for k in (0, 1)]
        self.last = (D - 1) % 2
        self.perm = rows[self.last] if rows[self.last] is not None else \
            torch.empty(n, dtype=torch.int32, device=dev)
        orig64 = [int(k.dtype == torch.int64) for k in keys]
        ints = lambda xs: (ctypes.c_int * max(len(xs), 1))(*xs)
        first = plan[0]
        self.args = [len(keys), (ctypes.c_void_p * len(keys))(
            *(k.data_ptr() for k in keys)), ints(orig64),
            (ctypes.c_longlong * len(keys))(*(PADS[k.dtype] for k in keys)),
            ints(bits), ints(radix_offsets(bits) if first.hist_src < 0
                             else (0,) * len(keys)),
            len(first.keys), ints(first.keys), ints(first.offs), ints(recs),
            D]
        self.lib, self.keys, self.fault, self.values = lib, keys, fault, \
            values
        self.rows, self.scratch, self.vals, self.n = rows, scratch, None, n
        self.steps = D + 1
        self.stream = ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream)

    def run(self, a: int, b: int) -> None:
        if self.values and b == self.steps:
            # the last pass's values, allocated once the word buffer it
            # does not read is freed
            self.words[self.last] = None
            self.vals = torch.empty(self.n, dtype=self.keys[0].dtype,
                                    device=self.keys[0].device)
        ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())
        with torch.cuda.device(self.keys[0].device):
            err = self.lib.radix_sort_run(
                *self.args, a, b, ptr(self.words[0]), ptr(self.words[1]),
                ptr(self.rows[0]), ptr(self.rows[1]), ptr(self.perm),
                ptr(self.vals), self.n, ptr(self.scratch), ptr(self.fault),
                self.stream)
        if err != 0:
            raise RuntimeError(f"radix_sort launch failed: CUDA error {err}")
        LAUNCHES["radix_hist"] += int(a == 0)
        LAUNCHES["radix_pass"] += b - max(a, 1)

    def result(self):
        return (self.perm, self.vals) if self.values else self.perm


def radix_sort_cuda(keys, bits, fault, values: bool = False, scratch=None):
    """Launch ``radix_hist`` and one ``radix_pass`` a digit (one C call,
    radix_sort_run; with ``values`` the last pass in a second) on the CUDA
    keys (1-D int32 or int64, equal lengths, most significant first, each
    ``bits`` wide; ops/sort's contract): returns the stable permutation
    (int32[n]) and, with ``values``, the first key's sorted values. A key
    outside its width ORs its bit into ``fault`` (int32[1]); the wrapper
    does not synchronise. ``scratch``: radix_sort_scratch_bytes(n) zeroed
    bytes made by the caller (else made here). Same contract as
    ops/sort._stable_argsort_reference."""
    from ..ops.sort import PADS
    keys, bits = tuple(keys), tuple(int(b) for b in bits)
    if not keys or len(keys) != len(bits):
        raise ValueError("radix_sort: one width for each key, at least "
                         "one key")
    dev = keys[0].device
    n = int(keys[0].shape[0])
    for q, (k, b) in enumerate(zip(keys, bits)):
        if k.dtype not in PADS:
            raise ValueError(f"radix_sort: key {q} is {k.dtype}, not int32 "
                             "or int64")
        _check(f"key {q}", k, k.dtype, (n,), dev)
        top = 31 if k.dtype == torch.int32 else 63
        if not 1 <= b <= top:
            raise ValueError(f"radix_sort: key {q} ({k.dtype}) is {b} bits "
                             f"wide (1 .. {top})")
    _check("fault", fault, torch.int32, (1,), dev)
    if n >= 2**31 - 1:
        raise ValueError(f"radix_sort: {n} rows (fewer than 2^31 - 1)")
    if n == 0:
        perm = torch.empty(0, dtype=torch.int32, device=dev)
        return (perm, torch.empty_like(keys[0])) if values else perm
    sort = _RadixRun(load()["radix_sort"], keys, bits, fault, values,
                     scratch)
    D = sort.steps - 1
    # one C call a sort; with values, the last pass apart (the sort then
    # holds no more than the former one-call-a-pass wrapper held)
    for a, b in [(0, D), (D, D + 1)] if values and D > 1 else [(0, D + 1)]:
        sort.run(a, b)
    return sort.result()


def compact_cuda(flag, count: int, fault, scratch=None):
    """Launch ``compact`` on a CUDA bool tensor ``flag`` with ``count`` set
    flags: returns int32[n], the set rows in order, then the others in
    order. A count that is not the flags' ORs ops/sort.COUNT_FAULT into
    ``fault`` (int32[1]); the wrapper does not synchronise. ``scratch``:
    compact_scratch_bytes(n) zeroed bytes made by the caller (else made
    here). Same contract as ops/sort._compact_reference."""
    dev = flag.device
    n = int(flag.shape[0])
    _check("flag", flag, torch.bool, (n,), dev)
    _check("fault", fault, torch.int32, (1,), dev)
    if not 0 <= count <= n < 2**31 - 1:
        raise ValueError(f"compact: {count} set of {n} rows")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load()["compact"]
    # the look-back's ticket and states start at 0
    size = int(lib.compact_scratch_bytes(n))
    if scratch is None:
        scratch = torch.zeros(size, dtype=torch.uint8, device=dev)
    _check("scratch", scratch, torch.uint8, (size,), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.compact_launch(_ptr(flag), n, count, _ptr(out),
                                 _ptr(scratch), _ptr(fault),
                                 ctypes.c_void_p(stream))
    _launch("compact", err)
    return out


SA_BIN_SHIFT = 20   # a bin of sa_round's binned scatter: 2^20 positions
SA_MAX_BINS = 1024  # sa_round.cu's MAX_BINS
SA_FINE_SHIFT = 12  # its fine bins: 2^12 positions, at most 1024 a bin


class BinPlan(NamedTuple):
    """sa_round's bins over m text positions: ``bins`` of 2^``shift``
    positions each, the last ``last`` wide."""
    shift: int
    bins: int
    last: int


def sa_round_bins(m: int, shift: int = SA_BIN_SHIFT) -> BinPlan:
    """The bins of a full round's or the seed's scatter over m < 2^30
    positions: 2^shift positions each (2^20: a 2048-row tile's rows fall
    in runs of ~8 a bin at m = 252 M, and a bin holds 256 fine bins),
    widened until at most SA_MAX_BINS cover m; each bin holds at most
    1024 fine bins of 2^SA_FINE_SHIFT positions."""
    top = SA_FINE_SHIFT + 10
    if not 1 <= m < 1 << 30:
        raise ValueError(f"sa_round: m = {m} (1 .. 2^30 - 1)")
    if not SA_FINE_SHIFT <= shift <= top:
        raise ValueError(f"sa_round: bins of 2^{shift} "
                         f"(2^{SA_FINE_SHIFT} .. 2^{top})")
    while ((m - 1) >> shift) + 1 > SA_MAX_BINS:
        shift += 1
    bins = ((m - 1) >> shift) + 1
    return BinPlan(shift, bins, m - ((bins - 1) << shift))


# sa_round_pack_launch's layouts: (dtypes of the rows, words a row)
_PACK_LAYOUTS = {0: ((torch.int32,) * 4, 4),
                 1: ((torch.int64, torch.int32), 4),
                 2: ((torch.int64,) * 3, 8)}


def _sa_round_pack(lib, layout: int, rows, R: int, dev):
    """Launch ``sa_round_pack`` (its own C call): the rows side by side,
    int32[R + 8, words] (the last 8 rows room for the kernel)."""
    dtypes, kw = _PACK_LAYOUTS[layout]
    if len(rows) != len(dtypes):
        raise ValueError(f"sa_round: {len(rows)} key rows ({len(dtypes)})")
    for q, (row, dt) in enumerate(zip(rows, dtypes)):
        _check(f"key {q}", row, dt, (R,), dev)
    # 8 rows more: a full round's or the seed's second staging, laid over
    # K once it is read, takes 12 * ((m + 3) & ~3) bytes
    K = torch.empty((R + 8, kw), dtype=torch.int32, device=dev)
    ptrs = [_ptr(r) for r in rows] + [None] * (4 - len(rows))
    with torch.cuda.device(dev):
        err = lib.sa_round_pack_launch(
            layout, *ptrs, _ptr(K), R,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"sa_round_pack launch failed: CUDA error {err}")
    return K


def _sa_round_run(lib, mode: int, perm, K, m: int, k: int, *, ti=None,
                  lv_in=None, lv_out, mid=None, full, resolved, staging=(),
                  carry=(None, None, None)):
    """One ``sa_round_launch`` C call: the kernel, and for a full round or
    the seed the two placing kernels; returns the unresolved count
    (int32[1], on the device)."""
    dev, R = perm.device, int(perm.shape[0])
    plan = sa_round_bins(m, SA_BIN_SHIFT)
    # the look-back's ticket and states, the count and the bins' cursors
    # start at 0
    scratch = torch.zeros(int(lib.sa_round_scratch_bytes(R, m, plan.shift)),
                          dtype=torch.uint8, device=dev)
    ptr = lambda t: None if t is None else _ptr(t)
    st = list(staging) + [None] * (3 - len(staging))
    with torch.cuda.device(dev):
        err = lib.sa_round_launch(
            mode, _ptr(perm), _ptr(K), ptr(ti), ptr(lv_in), _ptr(lv_out),
            ptr(mid), _ptr(full), _ptr(resolved), *map(ptr, st),
            *map(ptr, carry), R, m, int(k), plan.shift, _ptr(scratch),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch("sa_round", err)
    at = int(lib.sa_round_count_offset())
    return scratch[at:at + 4].view(torch.int32)


def sa_round_cuda(perm, keys, lv, k: int, comp=None):
    """Launch ``sa_round`` on CUDA tensors: one round's rank step after
    its sort (perm int32[R], the stable order of the rows by ``keys``,
    four int32[R]; lv int32[m] split levels; ``comp`` None for a full
    round of R = m rows, else (ti int32[R], rank int32[m], resolved
    bool[m]) for a compacted one). ``keys`` given as a list is emptied
    once packed, so that rows the caller holds only there are freed
    before the staging is made.
    Returns (mid_rank, full_rank, resolved, lv, u, carry) with u the
    unresolved count (int32[1], on the device; the wrapper does not
    synchronise). Same contract as ops/joint_sa._round_ranks_reference."""
    dev = perm.device
    R, m = int(perm.shape[0]), int(lv.shape[0])
    i32, b8 = torch.int32, torch.bool
    _check("perm", perm, i32, (R,), dev)
    _check("lv", lv, i32, (m,), dev)
    if not 1 <= R <= m < 2**31 - 1 or (comp is None and not R == m < 2**30):
        raise ValueError(f"sa_round: {R} rows of m = {m} (a full round "
                         "sorts all m < 2^30)")
    if comp is not None:
        ti, rank, res_in = comp
        _check("ti", ti, i32, (R,), dev)
        _check("rank", rank, i32, (m,), dev)
        _check("resolved", res_in, b8, (m,), dev)
    lib = load()["sa_round"]
    K = _sa_round_pack(lib, 0, keys, R, dev)
    if isinstance(keys, list):
        keys.clear()
    if comp is None:
        mid_rank, full_rank, lv_out = (torch.empty(m, dtype=i32, device=dev)
                                       for _ in range(3))
        resolved = torch.empty(m, dtype=b8, device=dev)
        staging = [torch.empty(m, dtype=i32, device=dev) for _ in range(3)]
        u = _sa_round_run(lib, 0, perm, K, m, k, lv_in=lv, lv_out=lv_out,
                          mid=mid_rank, full=full_rank, resolved=resolved,
                          staging=staging)
        return mid_rank, full_rank, resolved, lv_out, u, None
    # the kernel writes only the live rows of these
    mid_rank, full_rank = rank.clone(), rank.clone()
    resolved, lv_out = res_in.clone(), lv.clone()
    carry = (torch.empty(R, dtype=i32, device=dev),
             torch.empty(R, dtype=i32, device=dev),
             torch.empty(R, dtype=b8, device=dev))
    u = _sa_round_run(lib, 1, perm, K, m, k, ti=ti, lv_out=lv_out,
                      mid=mid_rank, full=full_rank, resolved=resolved,
                      carry=carry)
    return mid_rank, full_rank, resolved, lv_out, u, carry


def sa_round_seed_cuda(order, rows, sl: int):
    """Launch ``sa_round``'s seed mode on CUDA tensors: the seed's rank
    step after its sort (order int32[m], the stable order of the positions
    by ``rows``: the narrow seed's pack int64[m] and payload int32[m], or
    the wide seed's two packs and payload, int64[m] each; ``sl`` the seed
    level). ``rows`` given as a list is emptied once packed.
    Returns (split_lv, rank, resolved, u0): split_lv int32[m] in SA order
    (sl at a group start, else 0), rank int32[m] (the group's first row)
    and resolved bool[m] (a singleton) in text order, u0 the unresolved
    count (int32[1], on the device; the wrapper does not synchronise).
    Same contract as ops/joint_sa._seed_ranks_reference."""
    dev = order.device
    m = int(order.shape[0])
    i32 = torch.int32
    _check("order", order, i32, (m,), dev)
    if not 1 <= m < 2**30:
        raise ValueError(f"sa_round: the seed of m = {m} (1 .. 2^30 - 1)")
    layout = 1 if len(rows) == 2 else 2
    lib = load()["sa_round"]
    K = _sa_round_pack(lib, layout, rows, m, dev)
    if isinstance(rows, list):
        rows.clear()
    split_lv, rank = (torch.empty(m, dtype=i32, device=dev)
                      for _ in range(2))
    resolved = torch.empty(m, dtype=torch.bool, device=dev)
    staging = [torch.empty(m, dtype=i32, device=dev) for _ in range(2)]
    u0 = _sa_round_run(lib, 2 if layout == 1 else 3, order, K, m, sl,
                       lv_out=split_lv, full=rank, resolved=resolved,
                       staging=(staging[0], None, staging[1]))
    return split_lv, rank, resolved, u0


class RankWork:
    """The zeroed scratch of one suffix sort's rank steps, one part a step
    (``steps`` full steps, dense_rank_cuda; ``comp_steps`` compacted
    calls, dense_rank_comp_cuda), and a full step's two stagings, made
    once for the sort (each made per step otherwise); ``checked``: the
    sets of buffers the compacted calls have checked (_comp_checked)."""

    def __init__(self, n: int, steps: int, dev, comp_steps: int = 0):
        lib = load()["sa_round"]
        self.shift = sa_round_bins(n, SA_BIN_SHIFT).shift
        # every step's ticket, words and look-back states start at 0
        self.stride = -(-int(lib.sa_round_scratch_bytes(n, n, self.shift))
                        // 128) * 128
        self.comp_stride = int(lib.dense_rank_comp_scratch_bytes(n))
        self.scratch = torch.zeros(steps * self.stride
                                   + comp_steps * self.comp_stride,
                                   dtype=torch.uint8, device=dev)
        self.n, self.steps, self.used = n, steps, 0
        self.comp_steps, self.comp_used = comp_steps, 0
        self.st = self.st2 = None
        self.checked = set()

    def take(self) -> torch.Tensor:
        """The next full step's part of the scratch."""
        if self.used == self.steps:
            raise RuntimeError(f"RankWork: all {self.steps} steps taken")
        self.used += 1
        return self.scratch[(self.used - 1) * self.stride:
                            self.used * self.stride]

    def take_comp(self) -> tuple:
        """The next compacted call's part of the scratch: its address and
        the int32[4] view of the words the host reads."""
        if self.comp_used == self.comp_steps:
            raise RuntimeError(f"RankWork: all {self.comp_steps} compacted "
                               "steps taken")
        at = self.steps * self.stride + self.comp_used * self.comp_stride
        self.comp_used += 1
        return (self.scratch.data_ptr() + at,
                self.scratch[at + 4:at + 20].view(torch.int32))

    def stagings(self):
        if self.st is None:
            m4 = (self.n + 3) & ~3
            self.st, self.st2 = (torch.empty(2 * m4, dtype=torch.int32,
                                             device=self.scratch.device)
                                 for _ in range(2))
        return self.st, self.st2


def dense_rank_cuda(order, s0, key1, fault, out=None, *, nxt=None,
                    shift: int = 0, slice_=None, work=None):
    """Launch ``dense_rank`` (sa_round.cu) on CUDA tensors: the full rank
    step of a doubling round after its sort (order int32[n], the stable
    order of the rows by (key 0, key 1); s0 int32[n], key 0 in that
    order; key1 int32[n] in text order, or None for one key; ``fault``
    the sorts' fault word). Dense ranks by default, with ``nxt``
    (int32[n]) the next round's key 1 at ``shift``, rank[t + shift] + 1
    (0 past the end); with ``slice_`` = (ti, k0, k1), int32[cap] each,
    cap >= 1, group-start ranks (the sorted index of the row's group's
    first row), the unresolved rows' text positions and ranks in ti and
    k0 (sorted order, the first cap of them) and their key 1 at ``shift``
    in k1 (no ``nxt``). Returns (rank, top): rank
    int32[n] in text order (into ``out``, a contiguous int32[n], where
    given; needed with ``slice_``) and top int32[2] on the device, the
    largest rank (dense) or the unresolved count, and the fault word as
    the kernel read it after the sort (the wrapper does not synchronise);
    with ``slice_`` top int32[3], also the slice's rows in groups larger
    than COMP_CAP.
    ``work``: a RankWork of n rows for the scratch and stagings (else
    made here). Same contract as index/device._dense_rank_reference."""
    dev = order.device
    n = int(order.shape[0])
    i32 = torch.int32
    _check("order", order, i32, (n,), dev)
    _check("s0", s0, i32, (n,), dev)
    if key1 is not None:
        _check("key1", key1, i32, (n,), dev)
    _check("fault", fault, i32, (1,), dev)
    if not 1 <= n < 2**30:
        raise ValueError(f"dense_rank: n = {n} (1 .. 2^30 - 1)")
    if slice_ is not None and (out is None or nxt is not None):
        raise ValueError("dense_rank: group-start ranks are written in "
                         "place (out), with the slice's key 1 (no nxt)")
    rank = torch.empty(n, dtype=i32, device=dev) if out is None else out
    _check("out", rank, i32, (n,), dev)
    if nxt is not None:
        _check("nxt", nxt, i32, (n,), dev)
    cap, ti, k0, k1 = 0, None, None, None
    if slice_ is not None:
        ti, k0, k1 = slice_
        cap = int(ti.shape[0])
        for name, t in (("ti", ti), ("k0", k0), ("k1", k1)):
            _check(name, t, i32, (cap,), dev)
        if cap < 1:
            raise ValueError("dense_rank: an empty slice")
    if not 0 <= shift < 2**31:
        raise ValueError(f"dense_rank: shift {shift}")
    work = RankWork(n, 1, dev) if work is None else work
    if work.n != n:
        raise ValueError(f"dense_rank: a RankWork of {work.n} rows for {n}")
    scratch = work.take()
    st, st2 = work.stagings()
    ptr = lambda t: None if t is None else _ptr(t)
    lib = load()["sa_round"]
    with torch.cuda.device(dev):
        err = lib.dense_rank_launch(
            int(slice_ is not None), _ptr(order), _ptr(s0), ptr(key1),
            _ptr(rank), ptr(nxt), int(shift), ptr(ti), ptr(k0), ptr(k1),
            cap, _ptr(st), _ptr(st2), n, work.shift,
            _ptr(scratch), _ptr(fault),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch("dense_rank", err)
    at = int(lib.sa_round_count_offset())
    return rank, scratch[at:at + (8 if slice_ is None else 12)].view(i32)


def _comp_checked(work, slice_, nxt_slice, rank, sa, fault) -> None:
    """Check a compacted call's buffers, once per suffix sort for each
    set of buffers (the two slices swap from round to round)."""
    key = tuple(t.data_ptr() for t in (*slice_, *nxt_slice, rank, sa,
                                       fault))
    if key in work.checked:
        return
    dev, i32 = rank.device, torch.int32
    m = int(rank.shape[0])
    names = ("ti", "k0", "k1", "ti_n", "k0_n")
    for name, t in zip(names, (*slice_, *nxt_slice)):
        _check(name, t, i32, None, dev)
        if t.dim() != 1:
            raise ValueError(f"dense_rank_comp: {name} is not 1-D")
    _check("rank", rank, i32, (m,), dev)
    _check("sa", sa, i32, (m,), dev)
    _check("fault", fault, i32, (1,), dev)
    if not 1 <= m < 2**30 or work.n != m:
        raise ValueError(f"dense_rank_comp: m = {m} (1 .. 2^30 - 1), a "
                         f"RankWork of {work.n} rows")
    if nxt_slice[0].shape != nxt_slice[1].shape:
        raise ValueError("dense_rank_comp: ti_n and k0_n differ in length")
    if nxt_slice[0].data_ptr() == slice_[0].data_ptr() or \
            nxt_slice[1].data_ptr() == slice_[1].data_ptr():
        raise ValueError("dense_rank_comp: the next slice overwrites the "
                         "slice")
    work.checked.add(key)


def dense_rank_comp_cuda(slice_, u: int, large: int, rank, sa, nxt_slice,
                         shift: int, fault, work=None, tail: int = 0):
    """Launch ``dense_rank_comp`` (sa_round.cu) on CUDA tensors: a
    compacted round's rank step over the first u rows of the slice of
    unresolved rows, ``slice_`` = (ti, k0, k1), int32: text positions, key
    0 (the rank each row had: its group's start, nondecreasing, so a
    group's rows are contiguous) and key 1. Each group of at most
    COMP_CAP rows is sorted by key 1 in shared memory
    (comp_round_kernel); the ``large`` rows in larger groups (as the round
    before counted them) are picked, sorted by (key 0, key 1) on
    radix_sort and ranked by comp_large_kernel first. Writes rank[t] =
    key 0 + (F - G) and sa[key 0 + (r - G)] = t for the slice's rows (rank
    and sa int32[m], in place), the unresolved rows' text positions and
    ranks in sorted order into ``nxt_slice`` = (ti_n, k0_n), int32[cap]
    each (cap >= u; not ti or k0), and with ``shift`` > 0 their key 1 at
    that shift into k1. With ``tail`` > 0 (u <= COMP_CAP) one block runs
    up to ``tail`` rounds from this one instead, each gathering its key 1
    at ``shift``, 2 ``shift``, ... itself, until none is left (a slice
    left into ``nxt_slice``). Returns top int32[4] on the device: the
    unresolved count, the fault word as the kernel read it, the next
    slice's rows in groups larger than COMP_CAP, the rounds run (the
    wrapper does not synchronise). ``work``: a RankWork of m rows with
    compacted steps left (else made here); the buffers are checked once
    per RankWork. Same contract as index/device._comp_rank_reference and
    _comp_tail_reference."""
    dev = rank.device
    m = int(rank.shape[0])
    if work is None:
        _check("rank", rank, torch.int32, None, dev)
        work = RankWork(m, 0, dev, 1)
    _comp_checked(work, slice_, nxt_slice, rank, sa, fault)
    ti, k0, k1 = slice_
    ti_n, k0_n = nxt_slice
    cap = int(ti_n.shape[0])
    if not 1 <= u <= min(int(t.shape[0]) for t in slice_) or u > m or \
            (cap < u and not tail):
        raise ValueError(f"dense_rank_comp: {u} rows of a slice of "
                         f"{[int(t.shape[0]) for t in slice_]}, m = {m}, a "
                         f"next slice of {cap}")
    if not 0 <= large <= u or (tail and (large or u > COMP_CAP)):
        raise ValueError(f"dense_rank_comp: {large} large rows of {u}"
                         + (f", a tail of more than {COMP_CAP}" if tail
                            else ""))
    if not (1 if tail else 0) <= shift < 2**31:
        raise ValueError(f"dense_rank_comp: shift {shift}")
    scratch, top = work.take_comp()
    scratch = ctypes.c_void_p(scratch)
    lib = load()["sa_round"]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        if tail:
            err = lib.dense_rank_comp_tail_launch(
                _ptr(ti), _ptr(k0), _ptr(rank), _ptr(sa), m, _ptr(ti_n),
                _ptr(k0_n), cap, u, int(shift), int(tail), scratch,
                _ptr(fault), stream)
        else:
            large_rows = [None] * 7
            if large:
                picked = [torch.empty(large, dtype=torch.int32, device=dev)
                          for _ in range(3)]
                err = lib.dense_rank_comp_pick_launch(
                    _ptr(ti), _ptr(k0), _ptr(k1), u, int(large),
                    *map(_ptr, picked), scratch, _ptr(fault), stream)
                if err:
                    raise RuntimeError("dense_rank_comp's pick launch "
                                       f"failed: CUDA error {err}")
                perm, s0 = radix_sort_cuda(
                    picked[:2], (m.bit_length(), (m + 1).bit_length()),
                    fault, values=True)
                large_rows = [perm, s0, picked[1], picked[2]] + [
                    torch.empty(large, dtype=torch.int32, device=dev)
                    for _ in range(3)]
            ptr = lambda t: None if t is None else _ptr(t)
            err = lib.dense_rank_comp_launch(
                _ptr(ti), _ptr(k0), _ptr(k1), _ptr(rank), _ptr(sa), m,
                _ptr(ti_n), _ptr(k0_n), cap, u, int(large),
                *map(ptr, large_rows), int(shift), scratch, _ptr(fault),
                stream)
    _launch("dense_rank_comp", err)
    return top


def pair_expand_cuda(pos, length, key_k, isa_next, size, smaller, pair_lo,
                     ends, slot_base, bucket_pos, n_classes: int, total: int,
                     n: int, p_pad: int):
    """Launch ``pair_expand`` on CUDA tensors: tail_good's join rows from
    its classes (pos, length, key_k, isa_next, size int32[h_pad], smaller
    bool[h_pad], the first ``n_classes`` valid) and their pairs (pair_lo
    int32[h_pad]; ends int32[h_pad], the inclusive sum of the classes'
    pair counts, ``total`` pairs in all; bucket_pos int32[h_pad]), and the
    classes' slots slot_base int32[h_pad]. Returns (key1 int32[J], key2f
    int64[J], srcidx int32[J], pay int32[J], src_cls int32[p_pad]) with J
    = h_pad + p_pad. Same contract as
    engine/device_merge._pair_expand_reference."""
    dev = pos.device
    h_pad = int(pos.shape[0])
    i32 = torch.int32
    for name, t in (("pos", pos), ("length", length), ("key_k", key_k),
                    ("isa_next", isa_next), ("size", size),
                    ("pair_lo", pair_lo), ("ends", ends),
                    ("slot_base", slot_base), ("bucket_pos", bucket_pos)):
        _check(name, t, i32, (h_pad,), dev)
    _check("smaller", smaller, torch.bool, (h_pad,), dev)
    if not (0 <= n_classes <= h_pad and 0 <= total < p_pad <= 2**30
            and 1 <= n < 2**30):
        raise ValueError(f"pair_expand: {n_classes} classes of {h_pad}, "
                         f"{total} pairs of {p_pad}, n = {n}")
    J = h_pad + p_pad
    key1, srcidx, pay = (torch.empty(J, dtype=i32, device=dev)
                         for _ in range(3))
    key2f = torch.empty(J, dtype=torch.int64, device=dev)
    src_cls = torch.empty(p_pad, dtype=i32, device=dev)
    lib = load()["pair_expand"]
    with torch.cuda.device(dev):
        err = lib.pair_expand_launch(
            *map(_ptr, (pos, length, key_k, isa_next, size, smaller, pair_lo,
                        ends, slot_base, bucket_pos)),
            h_pad, int(n_classes), int(total), p_pad, int(n),
            *map(_ptr, (key1, key2f, srcidx, pay, src_cls)),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _launch("pair_expand", err)
    return key1, key2f, srcidx, pay, src_cls


def _runs_checked(run_len, run_char) -> int:
    dev = run_len.device
    R = int(run_len.shape[0])
    _check("run_len", run_len, torch.int32, (R,), dev)
    _check("run_char", run_char, torch.uint8, (R,), dev)
    if R >= 2**31 - 1:
        raise ValueError(f"run_output: {R} runs (at most 2^31 - 2)")
    return R


def _fault_view(lib, scratch: torch.Tensor) -> torch.Tensor:
    at = int(lib.run_output_fault_offset())
    return scratch[at:at + 4].view(torch.int32)


def rle_pack_cuda(run_len, run_char):
    """Launch ``rle_pack`` on a merged run list (CUDA int32[R] lengths,
    uint8[R] chars): returns (uint8[9 * max(R, 1)], the .rl_bwt's records,
    fault int32[1]); the fault word is not 0 when a length is not positive
    or a char equals its predecessor's (io/output.check_fault reads it).
    Same contract as io/output.rle_pack_reference; the wrapper does not
    synchronise."""
    dev = run_len.device
    R = _runs_checked(run_len, run_char)
    lib = load()["run_output"]
    out = torch.empty(9 * max(R, 1), dtype=torch.uint8, device=dev)
    # the fault word starts at 0
    scratch = torch.zeros(int(lib.run_output_scratch_bytes(0)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.rle_pack_launch(_ptr(run_len), _ptr(run_char), R,
                                  _ptr(out), _ptr(scratch),
                                  ctypes.c_void_p(stream))
    _launch("rle_pack", err)
    return out, _fault_view(lib, scratch)


def bwt_expand_cuda(run_len, run_char, sn: int):
    """Launch ``bwt_expand`` on a merged run list (CUDA int32[R] lengths,
    uint8[R] chars, R >= 1) whose lengths sum to ``sn``: returns
    (uint8[sn], the .bwt's bytes, fault int32[1]); the fault word is not 0
    when a length is not positive or the lengths do not sum to sn. Same
    contract as io/output.bwt_expand_reference; the wrapper does not
    synchronise. The run ends (int32[R]) and the look-back's scratch are
    made here."""
    dev = run_len.device
    R = _runs_checked(run_len, run_char)
    if not (R >= 1 and 1 <= sn < 2**31):
        raise ValueError(f"bwt_expand: {R} runs, sn {sn}")
    lib = load()["run_output"]
    out = torch.empty(sn, dtype=torch.uint8, device=dev)
    ends = torch.empty(R, dtype=torch.int32, device=dev)
    # the look-back's ticket and states and the fault word start at 0
    scratch = torch.zeros(int(lib.run_output_scratch_bytes(R)),
                          dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.bwt_expand_launch(_ptr(run_len), _ptr(run_char), R, sn,
                                    _ptr(ends), _ptr(out), _ptr(scratch),
                                    ctypes.c_void_p(stream))
    _launch("bwt_expand", err)
    return out, _fault_view(lib, scratch)
