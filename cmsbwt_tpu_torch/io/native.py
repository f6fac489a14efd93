"""ctypes bindings for the native IO runtime (native/cmsbwt_io.cpp) — the
port's copy of the parse and writer bindings of cmsbwt_tpu/io/native.py.

The shared library is built on demand with g++ into ``$CMSBWT_NATIVE_DIR``
(default: ``build/`` beside this file); every entry point has a numpy
fallback (io/fasta.py, engine/merge.py) so the port works without a
toolchain.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "cmsbwt_io.cpp"


def _build_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get(
        "CMSBWT_NATIVE_DIR", pathlib.Path(__file__).resolve().parent / "build"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not _SRC.exists():
            return None
        so = _build_dir() / "libcmsbwt_io.so"
        try:
            if (not so.exists() or
                    so.stat().st_mtime < _SRC.stat().st_mtime):
                # build to a per-process temp and os.replace() (atomic) so a
                # concurrent process never CDLLs a half-written .so
                tmp_so = so.with_name(f".libcmsbwt_io.{os.getpid()}.so")
                r = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", str(_SRC),
                     "-o", str(tmp_so)], capture_output=True)
                if r.returncode != 0:
                    tmp_so.unlink(missing_ok=True)
                    return None
                os.replace(tmp_so, so)
            lib = ctypes.CDLL(str(so))
            lib.cms_parse_collection.restype = ctypes.c_int64
            lib.cms_parse_collection.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64)]
            lib.cms_write_plain.restype = ctypes.c_int64
            lib.cms_write_plain.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            lib.cms_write_rle.restype = ctypes.c_int64
            lib.cms_write_rle.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def parse_collection_native(path: str, sn_limit: int):
    """Native collection parse; returns (sx uint8 array, n_seps) or None."""
    lib = get_lib()
    if lib is None:
        return None
    fsize = os.path.getsize(path)
    out = np.empty(fsize + 2, dtype=np.uint8)
    n_seps = ctypes.c_int64(0)
    sn = lib.cms_parse_collection(
        path.encode(), ctypes.c_uint64(min(sn_limit, 2**64 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(n_seps))
    if sn < 0:
        return None
    return out[:sn], int(n_seps.value)


def write_plain_native(path: str, run_len: np.ndarray,
                       run_char: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    rl = np.ascontiguousarray(run_len, dtype=np.int64)
    rc = np.ascontiguousarray(run_char, dtype=np.uint8)
    r = lib.cms_write_plain(
        path.encode(), rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(rl))
    return r >= 0


def write_rle_native(path: str, run_len: np.ndarray,
                     run_char: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    rl = np.ascontiguousarray(run_len, dtype=np.int64)
    rc = np.ascontiguousarray(run_char, dtype=np.uint8)
    r = lib.cms_write_rle(
        path.encode(), rl.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(rl))
    return r >= 0
