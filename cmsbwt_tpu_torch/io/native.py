"""ctypes bindings for the native runtimes — the port's copy of
cmsbwt_tpu/io/native.py: the IO runtime (csrc/cmsbwt_io.cpp: parse,
the host and sharded merges' writers, the host merge's parallel sorts,
searches, tail walk and run expansion, and the device writer's copy into
its result) and the MS scan engine
(csrc/cmsbwt_scan.cpp, the ``native`` backend). Both sources are the
port's own copies of the JAX package's native/ files, beside this module.

Each shared library is built on demand with g++ into ``$CMSBWT_NATIVE_DIR``
(default: ``build/`` beside this file); every entry point has a numpy
fallback (io/fasta.py, engine/merge.py, engine/tails.py, the spec scan of
engine/ms_host.py; the copy's is ``ctypes.memmove`` in io/output.py) so
the port works without a toolchain.
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

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_SRC = CSRC / "cmsbwt_io.cpp"


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
            I64P = ctypes.POINTER(ctypes.c_int64)
            lib.cms_position_tails.restype = ctypes.c_int64
            lib.cms_position_tails.argtypes = [
                ctypes.c_int64, I64P, I64P, I64P, I64P, I64P,
                ctypes.POINTER(ctypes.c_uint8), I64P, I64P, I64P,
                ctypes.POINTER(ctypes.c_int32), I64P, I64P,
                ctypes.c_int64, I64P, I64P]
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


def copy_into_native(dst: int, dst_bytes: int, off: int, src: int, n: int,
                     threads: int):
    """The device writer's host copy (``cms_copy_into``, the GIL released
    as ctypes releases it): ``n`` bytes at address ``src`` to ``dst + off``
    of a result of ``dst_bytes`` at ``dst``, by ``threads`` threads; the
    first chunk (``off == 0``) advises the result's 2 MiB-aligned interior
    MADV_HUGEPAGE before its pages are touched. Returns the threads of the
    copy, or None (nothing copied) without the library."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_copy_into_bound"):
        lib.cms_copy_into.restype = ctypes.c_int64
        lib.cms_copy_into.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        lib._copy_into_bound = True
    if not (0 <= off and 0 < n and off + n <= dst_bytes):
        raise ValueError(f"copy_into: {n} bytes at {off} of {dst_bytes}")
    return int(lib.cms_copy_into(dst, dst_bytes, off, src, n, threads))


def position_tails_native(classes, cls_combo, slot_base, member_rank,
                          bmap, cls_lo, cls_hi, n_ref, h):
    """Native tail positioning; returns (counter, stats) or None."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as _np
    I64 = ctypes.POINTER(ctypes.c_int64)
    a = lambda x: _np.ascontiguousarray(x, dtype=_np.int64)
    pos = a(classes.pos)
    ln = a(classes.length)
    until = a(classes.until_next)
    size = a(classes.size)
    isa = a(classes.isa_next)
    smaller = _np.ascontiguousarray(classes.smaller, dtype=_np.uint8)
    combo = a(cls_combo)
    sb = a(slot_base)
    mr = a(member_rank)
    bm = _np.ascontiguousarray(bmap, dtype=_np.int32)
    lo = a(cls_lo)
    hi = a(cls_hi)
    counter = _np.zeros(h + 1, dtype=_np.int64)
    stats = _np.zeros(3, dtype=_np.int64)
    p64 = lambda x: x.ctypes.data_as(I64)
    r = lib.cms_position_tails(
        ctypes.c_int64(classes.n_classes), p64(pos), p64(ln), p64(until),
        p64(size), p64(isa),
        smaller.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        p64(combo), p64(sb), p64(mr),
        bm.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p64(lo), p64(hi), ctypes.c_int64(n_ref), p64(counter), p64(stats))
    if r != 0:
        return None
    return counter, stats


def _bind_argsort(lib):
    import ctypes as _ct
    if not hasattr(lib, "_argsort_bound"):
        lib.cms_stable_argsort_i64.restype = _ct.c_int64
        lib.cms_stable_argsort_i64.argtypes = [
            _ct.POINTER(_ct.c_int64), _ct.POINTER(_ct.c_int64), _ct.c_int64]
        lib._argsort_bound = True


def lexsort_native(keys_last_primary, size_threshold: int = 1 << 20):
    """np.lexsort drop-in backed by the native parallel stable sort.

    ``keys_last_primary``: sequence of int arrays, last key most significant
    (np.lexsort convention). Falls back to np.lexsort when the native lib is
    unavailable or the input is small.
    """
    lib = get_lib()
    m = len(keys_last_primary[0])
    if lib is None or m < size_threshold:
        return np.lexsort(tuple(keys_last_primary))
    _bind_argsort(lib)
    import ctypes as _ct
    perm = np.arange(m, dtype=np.int64)
    pp = perm.ctypes.data_as(_ct.POINTER(_ct.c_int64))
    for k in keys_last_primary:  # least significant first, stable chain
        ka = np.ascontiguousarray(k, dtype=np.int64)
        lib.cms_stable_argsort_i64(
            ka.ctypes.data_as(_ct.POINTER(_ct.c_int64)), pp, m)
    return perm


def argsort_native(keys, size_threshold: int = 1 << 20):
    """Stable single-key argsort via the native parallel sort."""
    return lexsort_native([keys], size_threshold)


def expand_slots_native(m_c, ex_mc, base_c, cls_start, counter, cls_char,
                        bwt_heads_slots, run_len, run_char):
    """Native slot-level run expansion for build_runs; fills run_len/run_char
    in place and returns csum_c, or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_expand_bound"):
        I64 = ctypes.POINTER(ctypes.c_int64)
        U8 = ctypes.POINTER(ctypes.c_uint8)
        lib.cms_expand_slots.restype = ctypes.c_int64
        lib.cms_expand_slots.argtypes = [
            ctypes.c_int64, I64, I64, I64, I64, I64, U8, U8, I64, U8, I64]
        lib._expand_bound = True
    nec = len(m_c)
    a = lambda x: np.ascontiguousarray(x, dtype=np.int64)
    u = lambda x: np.ascontiguousarray(x, dtype=np.uint8)
    mc, ex, bc, cst, cnt = a(m_c), a(ex_mc), a(base_c), a(cls_start), a(counter)
    cch, bh = u(cls_char), u(bwt_heads_slots)
    assert run_len.dtype == np.int64 and run_len.flags.c_contiguous
    assert run_char.dtype == np.uint8 and run_char.flags.c_contiguous
    csum = np.zeros(nec, dtype=np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    pu8 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    r = lib.cms_expand_slots(
        ctypes.c_int64(nec), p64(mc), p64(ex), p64(bc), p64(cst), p64(cnt),
        pu8(cch), pu8(bh), p64(run_len), pu8(run_char), p64(csum))
    if r != 0:
        return None
    return csum


def searchsorted_right_native(a, q, size_threshold: int = 1 << 20):
    """np.searchsorted(a, q, side='right') with a parallel native kernel for
    large inputs."""
    lib = get_lib()
    if lib is None or len(q) < size_threshold:
        return np.searchsorted(a, q, side="right").astype(np.int64)
    if not hasattr(lib, "_ss_bound"):
        I64 = ctypes.POINTER(ctypes.c_int64)
        lib.cms_searchsorted_right.restype = ctypes.c_int64
        lib.cms_searchsorted_right.argtypes = [
            I64, ctypes.c_int64, I64, ctypes.c_int64, I64]
        lib._ss_bound = True
    aa = np.ascontiguousarray(a, dtype=np.int64)
    qq = np.ascontiguousarray(q, dtype=np.int64)
    out = np.empty(len(qq), dtype=np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.cms_searchsorted_right(p64(aa), len(aa), p64(qq), len(qq), p64(out))
    return out


def lexsort2_native(primary, secondary, size_threshold: int = 1 << 20):
    """Stable argsort by (primary, secondary) in one native parallel pass
    (np.lexsort([secondary, primary]) equivalent)."""
    lib = get_lib()
    m = len(primary)
    if lib is None or m < size_threshold:
        return np.lexsort((secondary, primary))
    if not hasattr(lib, "_lex2_bound"):
        I64 = ctypes.POINTER(ctypes.c_int64)
        lib.cms_stable_argsort_2i64.restype = ctypes.c_int64
        lib.cms_stable_argsort_2i64.argtypes = [I64, I64, I64, ctypes.c_int64]
        lib._lex2_bound = True
    p = np.ascontiguousarray(primary, dtype=np.int64)
    s = np.ascontiguousarray(secondary, dtype=np.int64)
    perm = np.arange(m, dtype=np.int64)
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.cms_stable_argsort_2i64(p64(p), p64(s), p64(perm), m)
    return perm


def fill_class_ranks_native(member_off, member_head, rank_value, pseudo_cls,
                            rank_to_head) -> bool:
    """Write each class's rank value at its members' head indices (parallel
    over classes); skips the pseudo class. Returns False without the lib."""
    lib = get_lib()
    if lib is None:
        return False
    if not hasattr(lib, "_fill_bound"):
        I64 = ctypes.POINTER(ctypes.c_int64)
        lib.cms_fill_class_ranks.restype = ctypes.c_int64
        lib.cms_fill_class_ranks.argtypes = [
            ctypes.c_int64, I64, I64, I64, ctypes.c_int64, I64]
        lib._fill_bound = True
    mo = np.ascontiguousarray(member_off, dtype=np.int64)
    mh = np.ascontiguousarray(member_head, dtype=np.int64)
    rv = np.ascontiguousarray(rank_value, dtype=np.int64)
    assert rank_to_head.dtype == np.int64 and rank_to_head.flags.c_contiguous
    p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.cms_fill_class_ranks(len(mo) - 1, p64(mo), p64(mh), p64(rv),
                             ctypes.c_int64(int(pseudo_cls)),
                             p64(rank_to_head))
    return True


# ---------------------------------------------------------------------------
# Native MS scan engine (csrc/cmsbwt_scan.cpp) — separate library so the
# IO runtime stays loadable without it
# ---------------------------------------------------------------------------

_SCAN_LOCK = threading.Lock()
_SCAN_LIB = None
_SCAN_TRIED = False
_SCAN_SRC = CSRC / "cmsbwt_scan.cpp"


def get_scan_lib():
    """Load (building on demand) the native scan engine, or None."""
    global _SCAN_LIB, _SCAN_TRIED
    with _SCAN_LOCK:
        if _SCAN_LIB is not None or _SCAN_TRIED:
            return _SCAN_LIB
        _SCAN_TRIED = True
        if not _SCAN_SRC.exists():
            return None
        so = _build_dir() / "libcmsbwt_scan.so"
        try:
            if (not so.exists() or
                    so.stat().st_mtime < _SCAN_SRC.stat().st_mtime):
                tmp_so = so.with_name(f".libcmsbwt_scan.{os.getpid()}.so")
                r = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                     str(_SCAN_SRC), "-o", str(tmp_so)],
                    capture_output=True)
                if r.returncode != 0:
                    tmp_so.unlink(missing_ok=True)
                    return None
                os.replace(tmp_so, so)
            lib = ctypes.CDLL(str(so))
            U8P = ctypes.POINTER(ctypes.c_uint8)
            I32P = ctypes.POINTER(ctypes.c_int32)
            I64P = ctypes.POINTER(ctypes.c_int64)
            lib.cms_ms_scan.restype = ctypes.c_int64
            lib.cms_ms_scan.argtypes = [
                U8P, I32P, I32P, I32P, I32P, ctypes.c_int32,
                U8P, ctypes.c_int64, I64P, ctypes.c_int32,
                ctypes.c_int64, I64P, I64P, I64P, U8P, ctypes.c_int32]
            lib.cms_ms_scan_i64.restype = ctypes.c_int64
            lib.cms_ms_scan_i64.argtypes = [
                U8P, I64P, I64P, I64P, I64P, ctypes.c_int64,
                U8P, ctypes.c_int64, I64P, ctypes.c_int32,
                ctypes.c_int64, I64P, I64P, I64P, U8P, ctypes.c_int32]
            _SCAN_LIB = lib
        except Exception:
            _SCAN_LIB = None
        return _SCAN_LIB


def ms_scan_native(x_padded, sa, isa, lcp, plcp, n, sx, sep_positions,
                   nthreads: int = 0):
    """Native head-emitting MS scan; returns (t, pos, len, smaller) int64/
    bool arrays or None if the engine is unavailable."""
    lib = get_scan_lib()
    if lib is None:
        return None
    # int64-indexed variant for giant references (n >= 2^31: the sharded
    # mesh index is int64; the reference tool's int32 libsais cap is the
    # bound being lifted)
    wide = any(np.asarray(a).dtype == np.int64 for a in (sa, isa)) \
        or n >= 2**31
    it = np.int64 if wide else np.int32
    xp = np.ascontiguousarray(x_padded, dtype=np.uint8)
    sa_ = np.ascontiguousarray(sa, dtype=it)
    isa_ = np.ascontiguousarray(isa, dtype=it)
    lcp_ = np.ascontiguousarray(lcp, dtype=it)
    plcp_ = np.ascontiguousarray(plcp, dtype=it)
    sx_ = np.ascontiguousarray(sx, dtype=np.uint8)
    ends = np.ascontiguousarray(sep_positions, dtype=np.int64)
    sn = len(sx_)
    cap = max(1024, sn // 8)
    U8P = ctypes.POINTER(ctypes.c_uint8)
    I32P = ctypes.POINTER(ctypes.c_int32)
    I64P = ctypes.POINTER(ctypes.c_int64)
    while True:
        t = np.empty(cap, np.int64)
        pos = np.empty(cap, np.int64)
        ln = np.empty(cap, np.int64)
        sml = np.empty(cap, np.uint8)
        if wide:
            r = lib.cms_ms_scan_i64(
                xp.ctypes.data_as(U8P), sa_.ctypes.data_as(I64P),
                isa_.ctypes.data_as(I64P), lcp_.ctypes.data_as(I64P),
                plcp_.ctypes.data_as(I64P), ctypes.c_int64(n),
                sx_.ctypes.data_as(U8P), ctypes.c_int64(sn),
                ends.ctypes.data_as(I64P), ctypes.c_int32(len(ends)),
                ctypes.c_int64(cap), t.ctypes.data_as(I64P),
                pos.ctypes.data_as(I64P), ln.ctypes.data_as(I64P),
                sml.ctypes.data_as(U8P), ctypes.c_int32(nthreads))
        else:
            r = lib.cms_ms_scan(
                xp.ctypes.data_as(U8P), sa_.ctypes.data_as(I32P),
                isa_.ctypes.data_as(I32P), lcp_.ctypes.data_as(I32P),
                plcp_.ctypes.data_as(I32P), ctypes.c_int32(n),
                sx_.ctypes.data_as(U8P), ctypes.c_int64(sn),
                ends.ctypes.data_as(I64P), ctypes.c_int32(len(ends)),
                ctypes.c_int64(cap), t.ctypes.data_as(I64P),
                pos.ctypes.data_as(I64P), ln.ctypes.data_as(I64P),
                sml.ctypes.data_as(U8P), ctypes.c_int32(nthreads))
        if r >= 0:
            h = int(r)
            return t[:h], pos[:h], ln[:h], sml[:h] != 0
        cap = int(-r) + 16
