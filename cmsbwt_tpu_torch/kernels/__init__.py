"""Hand-written CUDA kernels of the port: build, load and launch.

Each kernel lives in ``csrc/`` as CUDA C++ for Hopper (sm_90a) with a plain
C entry point; the device merge's share ``csrc/tile_scan.cuh``.
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
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("ms_jump_scan.cu", "lcp_lift.cu", "dense_neighbors.cu",
           "running_fill.cu", "tail_good_join.cu", "run_merge.cu",
           "tail_exact_credit.cu")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIFT_THREADS = 256

LAUNCHES = {"ms_jump_scan": 0, "lcp_lift": 0, "dense_neighbors": 0,
            "running_fill": 0, "tail_good_join": 0, "bucket_sums": 0,
            "run_merge": 0, "tail_exact_credit": 0}
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
