"""Hand-written CUDA kernels of the port: build, load and launch.

Each kernel lives in ``csrc/`` as CUDA C++ for Hopper (sm_90a) with a plain
C entry point. ``load()`` compiles the sources with ``nvcc`` into a shared
library at first use (into ``build/`` beside this file, or
``$CMSBWT_TORCH_BUILD_DIR``; the file name carries a hash of the sources
and flags, so an edited source rebuilds) and binds it with ctypes. A build
or launch failure raises; nothing falls back to a plain version.

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
SOURCES = ("ms_jump_scan.cu",)
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
THREADS = 128

LAUNCHES = {"ms_jump_scan": 0}
BUILD = {"seconds": None, "path": None, "log": ""}

_lock = threading.Lock()
_lib = None


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


def load():
    """Build (first use) and load the kernel library; returns the ctypes
    handle. ``BUILD`` records the build time and the compiler's log."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [CSRC / s for s in SOURCES]
        digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
        for s in srcs:
            digest.update(s.read_bytes())
        so = _build_dir() / f"libcmsbwt_kernels-{digest.hexdigest()[:12]}.so"
        t0 = time.perf_counter()
        if not so.exists():
            tmp = so.with_name(f".{so.name}.{os.getpid()}")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                *map(str, srcs)],
                               capture_output=True, text=True)
            BUILD["log"] = r.stdout + r.stderr
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError("nvcc failed:\n" + BUILD["log"])
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ms_jump_scan_launch.restype = I
        lib.ms_jump_scan_launch.argtypes = (
            [P, LL, P, P, P, P, I, I, P, I, I, I, P, I, I]
            + [P] * 13 + [I, P])
        BUILD["seconds"] = time.perf_counter() - t0
        BUILD["path"] = str(so)
        _lib = lib
        return lib


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


def ms_jump_scan_cuda(x_padded, sa, isa, jump, gmax, sx_padded, state: dict,
                      chunk_ends, *, n: int, sn: int, cap: int, window: int,
                      rounds: int) -> dict:
    """Launch ``ms_jump_scan`` on CUDA tensors: every lane runs to the end
    of its chunk; ``state`` (see ops/ms_jump.jump_init_state) is updated in
    place and returned. Same contract as ms_jump_scan_reference."""
    dev = chunk_ends.device
    L = int(chunk_ends.shape[0])
    levels = int(jump.shape[0])
    i32, u8, b = torch.int32, torch.uint8, torch.bool
    _check("chunk_ends", chunk_ends, i32, (L,), dev)
    _check("x_padded", x_padded, u8, None, dev)
    _check("sa", sa, i32, (n,), dev)
    _check("isa", isa, i32, (n,), dev)
    _check("jump", jump, i32, (levels, n), dev)
    _check("gmax", gmax, i32, (levels, n), dev)
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
    lib = load()
    ptr = lambda a: ctypes.c_void_p(a.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.ms_jump_scan_launch(
            ptr(x_padded), x_padded.shape[0], ptr(sa), ptr(isa), ptr(jump),
            ptr(gmax), levels, n, ptr(sx_padded), sn, window, rounds,
            ptr(chunk_ends), L, cap,
            *(ptr(state[k]) for k in ("t", "length", "lb", "rb", "pos",
                                      "fin", "done", "nrec", "viol",
                                      "out_t", "out_pos", "out_len",
                                      "out_sml")),
            THREADS, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ms_jump_scan launch failed: CUDA error {err}")
    LAUNCHES["ms_jump_scan"] += 1
    return state
