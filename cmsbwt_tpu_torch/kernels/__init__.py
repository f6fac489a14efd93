"""Hand-written CUDA kernels of the port: build, load and launch.

Each kernel lives in ``csrc/`` as CUDA C++ for Hopper (sm_90a) with a plain
C entry point. ``load()`` compiles each source with its own ``nvcc``
process, all at once, into a shared library per source at first use (into
``build/`` beside this file, or ``$CMSBWT_TORCH_BUILD_DIR``; each file
name carries a hash of its source and the flags, so an edited source
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
SOURCES = ("ms_jump_scan.cu", "lcp_lift.cu", "dense_neighbors.cu")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIFT_THREADS = 256

LAUNCHES = {"ms_jump_scan": 0, "lcp_lift": 0, "dense_neighbors": 0}
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
        for s in SOURCES:
            src = CSRC / s
            digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
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
    if err != 0:
        raise RuntimeError(f"ms_jump_scan launch failed: CUDA error {err}")
    LAUNCHES["ms_jump_scan"] += 1
    return state


def lcp_lift_cuda(hist, packs, ai, bi, lv, m: int) -> torch.Tensor:
    """Launch ``lcp_lift`` on CUDA tensors: the lcp of each pair (ai, bi)
    by lifting from its split level lv through the rank history ``hist``
    [n_hist, m] and the seed ``packs`` [1 or 2, m]. Same contract as
    ops/joint_sa.lift_pairs; returns int32[len(ai)]."""
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
    sl = seed_level_of(packs)
    valid = (ai < m) & (bi < m)
    lmax = int(torch.where(valid, lv, 0).max()) if rows else 0
    if lmax - 2 - sl >= int(hist.shape[0]):
        raise ValueError("lcp_lift: split level beyond the rank history")
    h = torch.empty(rows, dtype=i32, device=dev)
    lib = load()["lcp_lift"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lcp_lift_launch(
            _ptr(hist), _ptr(packs), int(packs.shape[0]), _ptr(ai),
            _ptr(bi), _ptr(lv), _ptr(h), rows, m, sl, lmax, LIFT_THREADS,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"lcp_lift launch failed: CUDA error {err}")
    LAUNCHES["lcp_lift"] += 1
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
    lib = load()["dense_neighbors"]
    scratch = torch.empty(int(lib.dense_neighbors_scratch_bytes(m)),
                          dtype=torch.uint8, device=dev)
    outs = [torch.empty(m, dtype=i32, device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.dense_neighbors_launch(
            _ptr(sa), _ptr(ell), n, m, _ptr(scratch), *map(_ptr, outs),
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"dense_neighbors launch failed: CUDA error {err}")
    LAUNCHES["dense_neighbors"] += 1
    return tuple(outs)
