"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  — require CUDA; print the card's name and power limit, and the
   host's CPU model (the host merge's times are the host's).
2. build   — build the port's CUDA kernels from cmsbwt_tpu_torch/kernels/csrc.
3. kernel  — the CUDA ms_jump_scan (fed the index's 128-wide block trees)
   against its plain torch version (ms_jump_scan_reference, fed the
   [levels, n] sparse tables) on the card, on the raw scan state (records,
   nrec, viol): 200 Kbp x 8 docs at 1% SNP, the same with 8 record slots
   per lane (lanes overflow: records past the capacity are dropped and
   still counted, and viol is raised), a separator-dense case, an
   identical-copies case, a 4-char reference (augmented to 127 chars: a
   tree with no level above its one block), and the bench's primary shape,
   where the kernel is also timed at 32768 and 131072 lanes. Tolerance:
   exact equality (every value is an integer or a byte).
4. dense kernels — the CUDA lcp_lift and dense_neighbors against their
   plain torch versions (lift_pairs, neighbors_reference) on the card, on
   inputs from the port's own dense stages, on the bench's primary shape
   (wide seed), on 200 Kbp x 8 docs with an N run in each doc (narrow
   seed) and on a separator-dense case. The lift runs on the rho
   irreducible rows with lmax from the stats (the main path's call), on
   the rho_pad rows of the earlier call. dense_neighbors also runs on
   synthetic rows at the edges of its tiles, warps and carry rounds
   (m = 1, 31, 32, 33, a tile +- 1, three tiles +- 1, runs of tiles with
   no reference slot, every or no slot a reference slot, three carry
   chunks). Tolerance: exact equality.
5. jump slice — the port's CLI (jump scan + device merge, --device cuda)
   on the bench's primary workload (2 Mbp reference x 10 docs at 1% SNP,
   about 20 Mchars), plain and -r. Outputs must be byte-equal to the C++
   reference tool's (baseline/cms-bwt-ref, run on the same input list),
   the scan's heads equal to those of the native C++ PLCP-skip scan
   (native/cmsbwt_scan.cpp, built here with g++) at 4096 and 32768 lanes,
   and the CUDA kernel must have carried the scan. Then the host merge
   (merge_from_heads: numpy and the native OpenMP runtime) against the
   device merge on the jump scan's heads, twice each in turns:
   (run_len, run_char, counter) equal, the host runs normalised as the
   device merge emits them (empty runs dropped, equal neighbours joined);
   both times and the host merge's stages printed.
6. dense slice — the same CLI with --backend dense --merge-backend device
   on the same workload, plain and -r: bytes equal to the reference
   tool's, the dense scan's heads equal to the native scan's, and the
   lcp_lift and dense_neighbors kernels (not their plain versions) must
   have carried it. Prints the .log phases and the dense stage split.
   Then the routes that end in the host merge, plain and -r, bytes equal
   to the reference tool's: --backend device (the jump scan's heads
   expanded to every position), --backend native (its .log must name the
   native engine), --backend jump and dense with --merge-backend host, and
   the int64 route for collections at or above 2^31 chars, forced with
   CMSBWT_SN_BOUND=4000000 (the dense scan in 2 M-char blocks, heads to
   the host with an int64 t, the host merge; both dense kernels held to
   their plain versions on its first block); --backend host (the Python
   spec scan) on 30 Kbp x 8 docs, against the tool run on that input.
7. blocked slice — the same workload through the blocked dense scan: the
   CLI with --block-chars 4194304, plain and -r (bytes equal to the
   reference tool's; each dense kernel launched once per block try and no
   plain version), its heads equal to the native scan's; CMSBWT_HBM_GB=2,
   so that the memory guard chooses the blocks (its choice printed); a
   4-char context on the 200 Kbp workload, so that blocks retry (the
   retries printed; heads and reference index equal to the unblocked
   scan's); --checkpoint-dir run twice (the first saves each block and
   the whole-run dense_heads bundle; the second loads the bundle, scans no
   block and launches no dense kernel; bytes equal). Both dense kernels
   are held to their plain
   versions (exact) on the first 4 Mi-char block as the CLI ran it (its
   window, separator base and pad, from BlockLog).
8. 500 Mchar — the bench's ecoli_rle shape at BENCH_FULL=1 (5 Mbp x 100
   docs at 1% SNP, ~500 Mchars, above what the unblocked scan needs on an
   80 GB card) through the CLI with -r --no-rle-quirk and no
   --block-chars, so the guard chooses the blocks: its heads equal to the
   jump scan's on the card, the .rl_bwt decoding to sn chars with the
   collection's byte histogram (the quirk's extra residual runs would
   make it longer; its bytes against the reference tool are
   tools/profile_slice.py --blocked's check). Prints the blocks, retries,
   per-block stage marks (CMSBWT_PROFILE=1, stderr), phases, peak device
   bytes per block and the wall time. Then both dense kernels against
   their plain versions (exact) on that run's first block (m ~ 252 M,
   narrow seed), and the host merge on that run's heads: its .rl_bwt
   bytes equal to the device merge's (the CLI's), its stages printed.
9. auto, model, parallel — at the primary workload: the CLI with no
   --backend (auto), plain and -r, bytes equal to the reference tool's,
   the backend its .log names printed, and that route's kernels
   (ROUTE_KERNELS) must have carried it; the CMSBWT model on cuda,
   transform(backend="jump"), "dense" and "jump" again, each .bwt equal to
   the reference tool's, the device index built once; ms_dense on the
   200 Kbp workload against the jump scan's heads expanded per position
   (ops/ms_device.ms_scan_device): pos, length and is_head equal at every
   position, smaller at the heads; --parallel --block-chars 4194304
   (five blocks), plain and -r, bytes equal to the reference tool's,
   heads equal to the native scan's (and those of
   parallel/blocked.ms_dense_heads_parallel on the card), each dense
   kernel launched once per block try and no plain version.
10. mesh — the mesh modules on R = torch.cuda.device_count() ranks, one
   NCCL rank per card (a one-rank group on one card): the CLI with
   --backend jump and dense and --merge-backend sharded at the primary
   workload, plain and -r, bytes equal to the reference tool's (the .log
   must name merge_sharded); the mesh scan
   (parallel/mesh.ms_dense_heads_mesh) in 4 Mi-char blocks, its heads
   equal to the jump scan's and both dense kernels launched for every
   block on one rank; the giant-reference route
   (CMSBWT_GIANT_THRESHOLD=64: the sharded int64 index, the native int64
   scan, the host merge) on the short reference, plain and -r, bytes
   equal to the normal route's, launching no kernel. Prints each mesh
   run's rank start-up and work seconds and peak device bytes per rank
   (parallel/distributed.LAST_RUN).

Imports nothing of JAX or of the JAX package (an import hook refuses
``jax``, ``jaxlib`` and ``cmsbwt_tpu``, so the port is shown to stand
alone): its oracles are the two C++ programs above. The reference-index
cache (CMSBWT_INDEX_CACHE) and the native runtimes' builds
(CMSBWT_NATIVE_DIR) live in the work directory, so every run builds its
own.

The kernels line gives, per kernel, its time at the primary shape (CUDA
events around 5 launches back to back; lcp_lift on the rho rows; the
times at the other shapes are on the kernel lines above it), the largest
error over every comparison, its
plain version's, its launches on the main path (every CLI run of its
route, the model's transforms and ms_dense, the counts set to 0 before
each path and read after it; ``launches_by_run`` splits them by path,
with the runs, the block tries and the merge engine of each; the native
and host routes launch none),
and bound_ms: the bytes the function must
move at these inputs (each input read once, each output written once; for
gathers, the entries this run's data touches) over 3.35 TB/s, the H100
SXM's memory rate. No single PyTorch call computes any of the three
functions, so library_ms is null.
"""
from __future__ import annotations

import ctypes
import filecmp
import importlib.abc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuse JAX and the JAX package: the port must run without them."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "cmsbwt_tpu"):
            raise ImportError(f"{name}: blocked in chip_smoke.py (the port "
                              "imports neither JAX nor the JAX package)")
        return None


sys.meta_path.insert(0, _NoJax())

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "_smoke_work"
REF_BIN = ROOT / "baseline" / "cms-bwt-ref"
NATIVE_SCAN = ROOT / "native" / "cmsbwt_scan.cpp"
TOL = 0  # exact: integer and byte outputs
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA data sheet)
BIG_DOCS = 100              # bench ecoli_rle at BENCH_FULL=1 (bench.py:176)
# the kernels each --backend launches; native and host launch none
ROUTE_KERNELS = {"jump": ("ms_jump_scan",), "device": ("ms_jump_scan",),
                 "dense": ("lcp_lift", "dense_neighbors"), "native": (),
                 "host": ()}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# the CPU's brand string (CPUID leaves 0x80000002-4), for hosts whose
# /proc/cpuinfo reports no model name
CPUID_BRAND_SRC = r"""
#include <cpuid.h>
#include <cstdio>
#include <cstring>
int main() {
  unsigned r[12] = {0};
  for (unsigned i = 0; i < 3; ++i)
    if (!__get_cpuid(0x80000002u + i, &r[4 * i], &r[4 * i + 1],
                     &r[4 * i + 2], &r[4 * i + 3])) return 1;
  char s[49];
  std::memcpy(s, r, 48);
  s[48] = 0;
  std::puts(s);
  return 0;
}
"""


def host_cpu(work: pathlib.Path) -> str:
    """The host's CPU model and the logical CPUs this process may use (the
    host merge and the native scan run there): /proc/cpuinfo's model name,
    else the CPUID brand string (a small program built with g++ in
    ``work``), else the family and model numbers."""
    try:
        text = pathlib.Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""
    field = lambda k: (re.search(rf"^{k}\s*:\s*(.+)$", text, re.M)
                       or [None, "unknown"])[1].strip()
    name = field("model name")
    if name == "unknown":
        work.mkdir(parents=True, exist_ok=True)
        (work / "cpuid.cpp").write_text(CPUID_BRAND_SRC)
        r = subprocess.run(["g++", "-O2", "-o", str(work / "cpuid"),
                            str(work / "cpuid.cpp")], capture_output=True,
                           timeout=120)
        brand = "" if r.returncode else subprocess.run(
            [str(work / "cpuid")], capture_output=True, text=True,
            timeout=60).stdout.strip()
        name = brand or (f"model name unknown (cpu family "
                         f"{field('cpu family')}, model {field('model')})")
    return (f"{name}, {len(os.sched_getaffinity(0))} of {os.cpu_count()} "
            "logical CPUs")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs launched back to
    back between two CUDA events (so the host's launch overhead overlaps
    the device's work wherever the host keeps ahead)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wrap(b: bytes, width: int = 60) -> bytes:
    return b"\n".join(b[i:i + width] for i in range(0, len(b), width))


def write_workload(d: pathlib.Path, seed: int, ref_len: int, n_docs: int,
                   snp: float, doc_len: int | None = None,
                   n_run: int = 0) -> pathlib.Path:
    """Reference and collection FASTA files plus their input list, made as
    bench.py's make_workload makes them (uniform ACGT reference; each
    document a copy with max(1, ref_len * snp) random substitutions, none
    when snp is 0), so seed 42 at 2 Mbp x 10 docs x 1% is its primary.
    ``n_run`` > 0 overwrites a run of that many N bytes at a random place
    in each document (the dense scan then takes its narrow seed)."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    (d / "ref.fa").write_bytes(b">ref\n" + _wrap(ref.tobytes()) + b"\n")
    with open(d / "coll.fa", "wb") as f:
        for i in range(n_docs):
            arr = ref.copy()
            k = max(1, int(ref_len * snp)) if snp else 0
            idx = rng.choice(ref_len, k, replace=False)
            arr[idx] = rng.choice(acgt, size=k)
            if n_run:
                at = int(rng.integers(0, ref_len - n_run))
                arr[at:at + n_run] = ord("N")
            f.write(b">doc%d\n" % i + _wrap(arr[:doc_len].tobytes()) + b"\n")
    lst = d / "input.txt"
    lst.write_text(f"{d / 'ref.fa'}\n{d / 'coll.fa'}\n")
    return lst


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(moved: int) -> float:
    return moved / HBM_BYTES_PER_S * 1e3


def scan_bytes(ix, trees, split, st, cap: int) -> int:
    """Bytes the scan must move: the padded collection, the text, SA, ISA
    and both trees read once, the lane state read and written, and the
    records this run writes (13 bytes each)."""
    lane_state = nbytes(*(st[k] for k in ("t", "length", "lb", "rb", "pos",
                                          "fin", "done", "nrec", "viol")))
    written = int(torch.clamp(st["nrec"], max=cap).to(torch.int64).sum())
    return (nbytes(split.sx_padded, split.ends_dev, ix.x_padded, ix.sa,
                   ix.isa, trees.lcp, trees.g)
            + 2 * lane_state + 13 * written)


def write_short_reference(d: pathlib.Path, seed: int) -> pathlib.Path:
    """A 4-char reference (127 chars once augmented: the block trees have
    no level above their one block) and 40 random 300-char documents."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    (d / "ref.fa").write_bytes(b">ref\nACGT\n")
    (d / "coll.fa").write_bytes(b"".join(
        b">doc%d\n" % i + _wrap(rng.choice(acgt, 300).tobytes()) + b"\n"
        for i in range(40)))
    lst = d / "input.txt"
    lst.write_text(f"{d / 'ref.fa'}\n{d / 'coll.fa'}\n")
    return lst


def kernel_case(name, lst, lanes=4096, cap=None, expect_viol=None,
                window=64, reps=5, sweep=()):
    """CUDA kernel (block trees) vs plain version (sparse tables) on one
    input list, at the lane split and capacity that ms_jump_heads launches
    (or ``cap`` record slots per lane); then the kernel alone at each lane
    count of ``sweep``. Returns a result dict."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index.device import build_device_index
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    x_aug, coll = load_inputs(str(lst))
    ix = build_device_index(x_aug, "cuda")
    n, sn = ix.n, coll.sn
    gmax = mj.build_gmax_table(ix.plcp, n)
    trees = mj.build_block_trees(ix.lcp, ix.plcp, n)
    split = mj.split_lanes(coll.sx, lanes, window, "cuda")
    cap = split.cap if cap is None else cap
    head = (ix.x_padded, ix.sa, ix.isa)
    kw = dict(n=n, sn=sn, cap=cap, window=window)
    fresh = lambda: split.init_state(n, cap)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_st = mj.ms_jump_scan_reference(*head, ix.jump, gmax,
                                       split.sx_padded, fresh(),
                                       split.ends_dev, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    cu_st = kernels.ms_jump_scan_cuda(*head, trees, split.sx_padded, fresh(),
                                      split.ends_dev, **kw)
    torch.cuda.synchronize()
    err = 0
    for k in mj.STATE_FIELDS:
        a, b = ref_st[k], cu_st[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"kernel case {name}: field {k} shape/dtype differs")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0)

    def timed(sp, c):
        it = iter([sp.init_state(n, c) for _ in range(reps)])
        return cuda_ms(lambda: kernels.ms_jump_scan_cuda(
            *head, trees, sp.sx_padded, next(it), sp.ends_dev, n=n, sn=sn,
            cap=c, window=window), reps)
    ms = timed(split, cap)
    bound = bound_ms(scan_bytes(ix, trees, split, ref_st, cap))
    viol = bool(ref_st["viol"].any())
    log(f"kernel[{name}]: n={n} sn={sn} lanes={split.lanes} cap={cap} "
        f"tree_levels={len(trees.offsets)} "
        f"records={int(ref_st['nrec'].sum())} viol={viol} "
        f"max_abs_err={err} (tolerance {TOL}) cuda_ms={ms:.3f} "
        f"plain_ms={plain_ms:.1f} bound_ms={bound:.4f}")
    if err > TOL:
        fail(f"kernel case {name}: CUDA ms_jump_scan disagrees with "
             "ms_jump_scan_reference")
    if expect_viol is not None and viol != expect_viol:
        fail(f"kernel case {name}: viol={viol}, expected {expect_viol}")
    for more in sweep:
        sp = mj.split_lanes(coll.sx, more, window, "cuda")
        warm = kernels.ms_jump_scan_cuda(
            *head, trees, sp.sx_padded, sp.init_state(n), sp.ends_dev, n=n,
            sn=sn, cap=sp.cap, window=window)
        log(f"kernel[{name}]: lanes={sp.lanes} cap={sp.cap} "
            f"viol={bool(warm['viol'].any())} "
            f"cuda_ms={timed(sp, sp.cap):.3f}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)


def pow2_pad(rho: int, m: int) -> int:
    """The rows the dense scan lifted before it cut the lift to the rho
    irreducible rows: rho rounded up to a power of two (at least 16), at
    most m (the JAX package's compile bucket)."""
    return min(1 << max(4, (max(rho, 1) - 1).bit_length()), m)


def compare(kernel, name, plain, cuda_fn, plain_fn, what, moved, reps=5):
    """A kernel's outputs against its plain version's on the card (exact),
    then both timed; returns a result dict."""
    want = plain_fn()
    got = cuda_fn()
    torch.cuda.synchronize()
    if any(a.dtype != b.dtype or a.shape != b.shape
           for a, b in zip(want, got)):
        fail(f"{kernel}[{name}]: dtype or shape differs from {plain}")
    err = max((int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0) for a, b in zip(want, got))
    ms = cuda_ms(cuda_fn, reps)
    plain_ms = cuda_ms(plain_fn, 2)
    bound = bound_ms(moved)
    log(f"kernel {kernel}[{name}]: {what} max_abs_err={err} "
        f"(tolerance {TOL}) cuda_ms={ms:.3f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bound:.4f}")
    if err > TOL:
        fail(f"{kernel}[{name}]: CUDA kernel disagrees with {plain}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                outputs=want)


def dense_inputs(x_aug: np.ndarray, sx: np.ndarray, sep_base: int = 0,
                 pad: int | None = None) -> dict:
    """The dense scan's stages up to the lift on the card, as the main
    path runs them on one joint string: the whole collection ``sx``
    (ms_dense_heads_on_device), or one block's window of it with that
    block's separator base and collection pad ``pad`` (ms_dense.
    _scan_block). Returns the joint sort's outputs, the sorted pair rows
    (ai, bi, lv over all m slots), rho, lmax, rho_pad and the split-level
    histogram of the irreducible rows."""
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    n, sn = len(x_aug), len(sx)
    n_pad, sn_pad, _ = md.joint_geometry(n, sx)
    sn_pad = sn_pad if pad is None else pad
    m = n_pad + sn_pad
    x_u8 = md.upload_bytes(x_aug, n_pad, "cuda")
    sx_u8 = md.upload_bytes(sx, sn_pad, "cuda")
    wide = md.wide_seed_ok(x_u8[:n], sx_u8[:sn], m)
    b, sp = md._build_joint_core(x_u8, sx_u8, n, sn, sep_base, n_pad, sn_pad)
    del x_u8, sx_u8
    sa, isa, hist, packs, _, split_lv = js.joint_suffix_array(b, sp, m, wide)
    stats, ai, bi, lv = md._irreducible_slots(b, sp, sa, isa, split_lv, n,
                                              sn, m, n_pad)
    del b, sp, split_lv
    rho, lmax = md._lift_rows(stats)
    return dict(sa=sa, isa=isa, hist=hist, packs=packs, ai=ai, bi=bi, lv=lv,
                n=n, m=m, wide=wide, rho=rho, lmax=lmax,
                rho_pad=pow2_pad(rho, m),
                levels={k: c for k, c in enumerate(stats[1:].tolist())
                        if c})


def dense_kernel_case(name, x_aug, sx, sep_base=0, pad=None, rho_pad=True,
                      reps=5):
    """The CUDA lcp_lift and dense_neighbors against lift_pairs and
    neighbors_reference on the card, fed the port's own dense stages on
    one joint string (dense_inputs: the whole collection, or one block).
    The lift runs on the rho irreducible rows with lmax from the stats
    (the main path's call), and with ``rho_pad`` also on the rho_pad rows
    of the earlier call (lmax read back by the wrapper). Returns {kernel:
    result dict}; "lcp_lift" is the main path's call."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    d = dense_inputs(x_aug, sx, sep_base, pad)
    sa, isa, hist, packs, ai_all, bi_all, lv_all = (
        d[k] for k in ("sa", "isa", "hist", "packs", "ai", "bi", "lv"))
    n, m, wide, rho, lmax, rows_pad = (
        d[k] for k in ("n", "m", "wide", "rho", "lmax", "rho_pad"))
    seed = "wide" if wide else "narrow"
    log(f"lift rows[{name}]: m={m} seed={seed} rho={rho} "
        f"rho_pad={rows_pad} lmax={lmax} hist_levels={hist.shape[0]} "
        f"irreducible rows by split level {d['levels']}")
    del d
    out = {}

    def lift(rows, tag, **kw):
        ai, bi, lv = ai_all[:rows], bi_all[:rows], lv_all[:rows]
        return compare(
            "lcp_lift", f"{name},{tag}", "lift_pairs",
            lambda: (kernels.lcp_lift_cuda(hist, packs, ai, bi, lv, m,
                                           **kw),),
            lambda: (js.lift_pairs(hist, packs, ai, bi, lv, m),),
            f"m={m} seed={seed} rows={rows}",
            lift_bytes(packs, ai, bi, lv, m), reps)

    out["lcp_lift"] = lift(rho, "rho rows", lmax=lmax)
    if rho_pad:
        out["lcp_lift_rho_pad"] = lift(rows_pad, "rho_pad rows")
    h = out["lcp_lift"].pop("outputs")[0]
    ai = ai_all[:rho]
    ell = md._fill_ell(h, ai, isa, m)
    del hist, packs, ai_all, bi_all, lv_all, isa, h, ai
    torch.cuda.empty_cache()
    out["dense_neighbors"] = compare(
        "dense_neighbors", name, "neighbors_reference",
        lambda: kernels.dense_neighbors_cuda(sa, ell, n, m),
        lambda: md.neighbors_reference(sa, ell, n, m),
        f"m={m} ref_slots={n}", 24 * m, reps)   # sa, ell in; 4 rows out
    for r in out.values():
        r.pop("outputs", None)
    return out


def block_kernel_case(name, x_aug, sx, block: dict) -> dict:
    """dense_kernel_case on one block try of a blocked run, as BlockLog
    recorded it (its window, separator base and pad)."""
    return dense_kernel_case(
        f"{name}, block@{block['b0']} m={block['m']}", x_aug,
        sx[block["b0"]:block["end"]], block["sep_base"], block["bs_pad"],
        rho_pad=False)


NB_TILE = 4096        # dense_neighbors.cu: TILE
NB_CHUNK = 4096       # dense_neighbors.cu: CHUNK (tiles per carry block)


def neighbor_inputs(m: int, seed: int, ref_share: float, dead=None):
    """Synthetic sa/ell rows on the card: a share ``ref_share`` of
    reference slots (sa < n = 1000), none in the tiles [dead[0],
    dead[1])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1000
    is_ref = torch.rand(m, generator=g, device="cuda") < ref_share
    if dead is not None:
        is_ref[dead[0] * NB_TILE:dead[1] * NB_TILE] = False
    sa = torch.where(is_ref,
                     torch.randint(0, n, (m,), generator=g, device="cuda"),
                     torch.randint(n, 4 * n, (m,), generator=g,
                                   device="cuda")).to(torch.int32)
    ell = torch.randint(0, 50, (m,), generator=g, device="cuda",
                        dtype=torch.int32)
    return sa, ell, n


# (m, share of reference slots, tiles with no reference slot); the sizes
# of tests/test_torch_dense_neighbors_tiles.py, then three carry chunks
NEIGHBOR_CASES = {
    "m1": (1, 0.5, None), "m31": (31, 0.2, None), "m32": (32, 0.2, None),
    "m33": (33, 0.2, None), "tile-1": (NB_TILE - 1, 0.05, None),
    "tile": (NB_TILE, 0.05, None), "tile+1": (NB_TILE + 1, 0.05, None),
    "3tiles-1": (3 * NB_TILE - 1, 0.01, None),
    "3tiles+1": (3 * NB_TILE + 1, 0.01, None),
    "dead_tiles": (6 * NB_TILE + 5, 0.01, (1, 5)),
    "all_ref": (2 * NB_TILE + 7, 1.0, None),
    "no_ref": (2 * NB_TILE + 7, 0.0, None),
    "three_carry_chunks": ((2 * NB_CHUNK + 3) * NB_TILE + 1, 1e-6,
                           (NB_CHUNK - 40, NB_CHUNK + 2)),
}


def neighbor_cases() -> list:
    """dense_neighbors against neighbors_reference on synthetic rows at
    the edge sizes of its tiles, warps and carry chunks (exact)."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import ms_dense as md
    res = []
    for i, (case, (m, share, dead)) in enumerate(NEIGHBOR_CASES.items()):
        sa, ell, n = neighbor_inputs(m, 100 + i, share, dead)
        if case == "no_ref":
            n = 0
        res.append(compare(
            "dense_neighbors", case, "neighbors_reference",
            lambda: kernels.dense_neighbors_cuda(sa, ell, n, m),
            lambda: md.neighbors_reference(sa, ell, n, m),
            f"m={m} ref_share={share} dead_tiles={dead}", 24 * m, 2))
        res[-1].pop("outputs")
    return res


def lift_bytes(packs, ai, bi, lv, m: int) -> int:
    """Bytes lcp_lift must move: ai, bi, lv read and h written per row;
    per valid row, two 4-byte history entries per lifting level it runs
    (from its own level lv - 2, or the shared top for lv below the seed
    level, down to the seed level) and two seed packs."""
    from cmsbwt_tpu_torch.ops.joint_sa import seed_level_of
    sl = seed_level_of(packs)
    valid = (ai < m) & (bi < m)
    lmax = int(torch.where(valid, lv, 0).max()) if ai.numel() else 0
    top = torch.where(lv >= sl, lv - 2, lmax - 2)
    levels = torch.clamp(top - sl + 1, min=0)
    gathers = int(torch.where(valid, 8 * levels + 16, 0).to(torch.int64)
                  .sum())
    return 16 * int(ai.numel()) + gathers


def reference_outputs(lst: pathlib.Path, tag: str = "ref") -> dict:
    """.bwt and .rl_bwt bytes of the C++ reference tool on ``lst``."""
    if not REF_BIN.exists():
        fail(f"reference tool {REF_BIN.relative_to(ROOT)} is missing")
    out = {}
    for rle in (False, True):
        base = WORK / (tag + ("_rle" if rle else ""))
        t0 = time.perf_counter()
        r = subprocess.run([str(REF_BIN)] + (["-r"] if rle else [])
                           + ["-o", str(base), str(lst)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"reference tool exited {r.returncode}: {r.stderr[-2000:]}")
        out[rle] = base.with_suffix(".rl_bwt" if rle else ".bwt").read_bytes()
        log(f"oracle[{'rle' if rle else 'plain'}]: reference tool "
            f"{time.perf_counter() - t0:.2f} s, {len(out[rle])} bytes")
    return out


def native_heads(x_aug: np.ndarray, coll) -> tuple:
    """Head records (t, pos, len, smaller, char) of the native C++
    PLCP-skip scan, run on the port's reference index."""
    from cmsbwt_tpu_torch.index.device import build_device_index
    so = WORK / "libcmsbwt_scan.so"
    r = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-fopenmp",
                        str(NATIVE_SCAN), "-o", str(so)],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"g++ could not build the native scan: {r.stderr[-2000:]}")
    lib = ctypes.CDLL(str(so))
    U8P, I32P, I64P = (ctypes.POINTER(c) for c in
                       (ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64))
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.cms_ms_scan.restype = i64
    lib.cms_ms_scan.argtypes = [U8P, I32P, I32P, I32P, I32P, i32, U8P, i64,
                                I64P, i32, i64, I64P, I64P, I64P, U8P, i32]
    ix = build_device_index(x_aug, "cuda")
    xp, sa, isa, lcp, plcp = (getattr(ix, k).contiguous().cpu().numpy()
                              for k in ("x_padded", "sa", "isa", "lcp",
                                        "plcp"))
    sx = np.ascontiguousarray(coll.sx, np.uint8)
    seps = np.ascontiguousarray(coll.sep_positions, np.int64)
    sn = len(sx)
    cap = max(1024, sn // 8)
    while True:
        t, pos, ln = (np.empty(cap, np.int64) for _ in range(3))
        sml = np.empty(cap, np.uint8)
        h = lib.cms_ms_scan(
            xp.ctypes.data_as(U8P), sa.ctypes.data_as(I32P),
            isa.ctypes.data_as(I32P), lcp.ctypes.data_as(I32P),
            plcp.ctypes.data_as(I32P), ix.n, sx.ctypes.data_as(U8P), sn,
            seps.ctypes.data_as(I64P), len(seps), cap,
            t.ctypes.data_as(I64P), pos.ctypes.data_as(I64P),
            ln.ctypes.data_as(I64P), sml.ctypes.data_as(U8P), 0)
        if h >= 0:
            break
        cap = int(-h) + 16
    t, pos, ln, sml = t[:h], pos[:h], ln[:h], sml[:h] != 0
    return t, pos, ln, sml, sx[(t - 1) % max(sn, 1)]


def phases_from_log(path: pathlib.Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        if line.endswith(" ms") and ": " in line:
            k, v = line.split(": ", 1)
            out[k] = float(v[:-3])
    return out


class BlockLog:
    """Records every try of every block the blocked dense scans run, by
    wrapping ops/ms_dense._scan_block while in use: the block's window,
    bs_pad and m, whether it was retried, its host-clock seconds (device
    synced) and the peak device bytes while it ran. The peak statistic is
    reset as each block starts and ends, so ``gap_peak`` is the peak
    outside the blocks (the merge, the writer) and ``run_peak`` the peak
    of the whole span."""

    def __init__(self, md):
        self.md, self.orig = md, md._scan_block
        self.tries, self.gap_peak = [], 0

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.md._scan_block = self._spy
        return self

    def __exit__(self, *exc):
        self.md._scan_block = self.orig
        self._gap()

    def _gap(self):
        torch.cuda.synchronize()
        self.gap_peak = max(self.gap_peak, torch.cuda.max_memory_allocated())

    def _spy(self, x_u8, sx, n, **kw):
        self._gap()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = self.orig(x_u8, sx, n, **kw)
        torch.cuda.synchronize()
        m = int(x_u8.shape[0]) + kw["bs_pad"]
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        self.tries.append(dict(
            b0=kw["b0"], end=kw["end"], emit=kw["emit_len"],
            sep_base=kw["sep_base"], bs_pad=kw["bs_pad"], m=m,
            retried=out is None,
            s=round(time.perf_counter() - t0, 4), peak=peak,
            peak_per_joint_char=round(peak / m, 1)))
        return out

    @property
    def retries(self) -> int:
        return sum(t["retried"] for t in self.tries)

    @property
    def run_peak(self) -> int:
        return max([self.gap_peak] + [t["peak"] for t in self.tries])


def same_heads(a, b) -> bool:
    """Two DeviceHeadsResults hold the same h heads (t, pos, len, smaller,
    char), compared on the card."""
    h = a.h
    return h == b.h and all(
        torch.equal(getattr(a, k)[:h], getattr(b, k)[:h])
        for k in ("head_t", "head_pos", "head_len", "head_smaller",
                  "head_char"))


def normalized_runs(run_len: np.ndarray, run_char: np.ndarray) -> tuple:
    """A run list as the device merge emits it: empty runs dropped and
    neighbours of one char joined."""
    keep = run_len > 0
    run_len, run_char = run_len[keep], run_char[keep]
    new = np.ones(len(run_char), dtype=bool)
    new[1:] = run_char[1:] != run_char[:-1]
    starts = np.nonzero(new)[0]
    return np.add.reduceat(run_len, starts) if len(starts) else run_len, \
        run_char[new]


def host_merge(x_aug: np.ndarray, dres, d: int, sn: int, rle_quirk: bool):
    """The host merge (engine/pipeline.merge_from_heads) on a device scan's
    heads, downloaded once; returns (PipelineResult, {stage: ms}, ms)."""
    from cmsbwt_tpu_torch.engine import pipeline as pl
    from cmsbwt_tpu_torch.utils.timing import PhaseTimer
    index, heads = pl.dense_result_to_inputs(
        x_aug, pl.download_heads_result(dres, len(x_aug)))
    timer = PhaseTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pl.merge_from_heads(index, heads, d, sn, rle_quirk, "cuda", timer)
    ms = (time.perf_counter() - t0) * 1e3
    return res, {k: round(t * 1e3, 1) for k, t in timer.phases}, ms


def rle_histogram(path: pathlib.Path) -> np.ndarray:
    """Chars per byte value of an .rl_bwt (records of a uint64 LE run
    length and the run's char)."""
    rec = np.fromfile(path, dtype=[("len", "<u8"), ("chr", "u1")])
    return np.bincount(rec["chr"], weights=rec["len"].astype(np.float64),
                       minlength=256).astype(np.int64)


def phase9(run_cli, check_counts, reset_counts, check_heads, paths, lst,
           oracle, k200k, x_aug, coll) -> None:
    """auto (the CLI with no --backend), the CMSBWT model, ms_dense and
    --parallel on the card, each held to its oracle and its kernels
    counted."""
    from cmsbwt_tpu_torch import CMSBWT
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index import device as idev
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops.ms_device import ms_scan_device
    from cmsbwt_tpu_torch.parallel import blocked as pb

    # the default CLI: auto resolves, and the resolved route's kernels
    # carry it
    run_cli(None, "auto_default", merge="auto")
    log(f"auto[primary]: the default CLI ran backend {paths[-1][0]}")

    # the model: the device index built once over three transforms
    built = []
    orig = idev.build_device_index

    def spy(*a, **kw):
        built.append(1)
        return orig(*a, **kw)
    idev.build_device_index = spy
    try:
        ref_path, coll_path = lst.read_text().split()
        model = CMSBWT(ref_path, device="cuda")
        for tag, be in (("model_jump", "jump"), ("model_dense", "dense"),
                        ("model_jump_again", "jump")):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = model.transform(coll_path, backend=be)
            wall = time.perf_counter() - t0
            if res.bwt != oracle[False]:
                fail(f"{tag}: CMSBWT.transform's bwt differs from the "
                     "reference tool's")
            log(f"model[{tag}]: bytes equal to the reference tool's; wall "
                f"{wall:.2f} s; phases ms " + json.dumps(
                    {k: round(t * 1e3, 1) for k, t in res.timer.phases}))
            check_counts(be, tag, 1, ROUTE_KERNELS[be])
        del model, res
    finally:
        idev.build_device_index = orig
    log(f"model: device index built {len(built)} time(s) over 3 transforms")
    if len(built) != 1:
        fail("CMSBWT built its device index more than once")
    torch.cuda.empty_cache()

    # ms_dense against the jump scan's heads expanded per position
    x2, c2 = load_inputs(str(k200k))
    reset_counts()
    dm = md.ms_dense(x2, c2.sx, "cuda")
    check_counts("dense", "ms_dense", 1, ROUTE_KERNELS["dense"],
                 engine="none")
    dv = ms_scan_device(idev.build_device_index(x2, "cuda"), c2.sx, "cuda")
    heads = dv.is_head
    same = (np.array_equal(dm.pos, dv.pos)
            and np.array_equal(dm.length, dv.length)
            and np.array_equal(dm.is_head, dv.is_head)
            and np.array_equal(dm.smaller[heads], dv.smaller[heads]))
    log(f"ms_dense[200Kbp_x8]: sn={c2.sn} m={dm.m} heads={int(heads.sum())} "
        f"irreducible={dm.irreducible}; pos, length, is_head at every "
        f"position and smaller at the heads equal to the expanded jump "
        f"scan's: {same}")
    if not same:
        fail("ms_dense differs from the expanded jump scan")
    del dm, dv, x2, c2
    torch.cuda.empty_cache()

    # --parallel in 4 Mi-char blocks: bytes, heads, a kernel launch per
    # block try
    bc = 4 << 20
    with BlockLog(md) as blk:
        run_cli("dense", "dense_parallel",
                ["--parallel", "--block-chars", str(bc)], blocks=blk)
    starts = sorted({t["b0"] for t in blk.tries})
    if starts != list(range(0, coll.sn, bc)):
        fail(f"--parallel ran blocks at {starts}")
    log(f"parallel[primary]: {len(starts)} blocks, {len(blk.tries)} tries "
        "over 2 runs")
    check_heads(pb.ms_dense_heads_parallel(x_aug, coll.sx, bc,
                                           device="cuda"), "dense parallel")
    torch.cuda.empty_cache()


def phase10(run_cli, check_counts, reset_counts, lst, x_aug, coll) -> None:
    """The sharded merge after jump and dense, the mesh scan and the giant
    route, on R = torch.cuda.device_count() ranks (one NCCL rank per card),
    each held to its oracle and its kernels counted."""
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    from cmsbwt_tpu_torch.parallel import distributed
    from cmsbwt_tpu_torch.parallel.mesh import ms_dense_heads_mesh
    t10 = time.perf_counter()
    ranks = torch.cuda.device_count()
    # the sharded merge: bytes against the reference tool's (phase 5's)
    for be in ("jump", "dense"):
        run_cli(be, f"{be}_sharded", merge="sharded")
        log(f"mesh[{be}_sharded]: {ranks} NCCL rank(s); last run "
            + json.dumps(distributed.LAST_RUN))
    # the mesh scan in 4 Mi-char blocks: heads against the jump scan's
    bc = 4 << 20
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = ms_dense_heads_mesh(x_aug, coll.sx, bc, device="cuda")
    wall = time.perf_counter() - t0
    blocks = -(-coll.sn // bc)
    counts = check_counts("dense", "mesh_scan", 1, ROUTE_KERNELS["dense"],
                          engine="none")
    if ranks == 1 and not (counts["lcp_lift"] == counts["dense_neighbors"]
                           >= blocks):
        fail(f"the mesh scan's {blocks} blocks launched {counts}")
    jres = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    h = jres.h
    want = [getattr(jres, k)[:h].cpu().numpy() for k in (
        "head_t", "head_pos", "head_len", "head_smaller", "head_char")]
    got = [mres.head_t, mres.head_pos, mres.head_len, mres.head_smaller,
           mres.head_char]
    if mres.h != h or any(not np.array_equal(g.astype(w.dtype), w)
                          for g, w in zip(got, want)):
        fail(f"the mesh scan's heads differ from the jump scan's "
             f"(h={mres.h} vs {h})")
    log(f"mesh[scan]: {ranks} rank(s), {blocks} blocks of {bc}, h={h} equal "
        f"to the jump scan's; irreducible={mres.irreducible}; wall "
        f"{wall:.2f} s; last run " + json.dumps(distributed.LAST_RUN))
    del jres, mres
    torch.cuda.empty_cache()
    # the giant route on the short reference: the normal route's bytes
    short = WORK / "kshort" / "input.txt"
    normal = run_cli("jump", "giant_normal", inp=short, want=None)
    del normal
    os.environ["CMSBWT_GIANT_THRESHOLD"] = "64"
    try:
        run_cli(None, "giant", inp=short, want=None, merge="auto",
                want_merge="host")
    finally:
        del os.environ["CMSBWT_GIANT_THRESHOLD"]
    for ext in (".bwt", ".rl_bwt"):
        a = (WORK / f"port_giant{'_rle' if ext == '.rl_bwt' else ''}"
             ).with_suffix(ext).read_bytes()
        b = (WORK / f"port_giant_normal{'_rle' if ext == '.rl_bwt' else ''}"
             ).with_suffix(ext).read_bytes()
        if a != b:
            fail(f"the giant route's {ext} differs from the normal route's")
    log(f"mesh[giant]: CMSBWT_GIANT_THRESHOLD=64 on the short reference: "
        f"bytes equal to the normal route's; last run "
        + json.dumps(distributed.LAST_RUN))
    log(f"mesh: phase 10 took {time.perf_counter() - t10:.1f} s")


def main() -> int:
    started = time.perf_counter()
    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} "
        f"device_name={kind} count={torch.cuda.device_count()}")

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    os.environ.setdefault("CMSBWT_NATIVE_DIR", str(WORK / "native"))
    os.environ["CMSBWT_INDEX_CACHE"] = str(WORK / "index_cache")
    try:
        log(f"host: {host_cpu(WORK)}")
        return run_phases(card, kind, started)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def run_phases(card: str, kind: str, started: float) -> int:
    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    from cmsbwt_tpu_torch.utils.buckets import bucket_size

    # phase 2: build
    kernels.load()
    log(f"build: {kernels.BUILD['seconds']:.2f} s -> {kernels.BUILD['path']}")
    entry = ""
    for line in kernels.BUILD["log"].splitlines():
        m = re.search(r"_cu_[0-9a-f]{8}(\d+)", line)
        if "Compiling entry function" in line and m:   # mangled name
            at = m.end()
            entry = line[at:at + int(m.group(1))]
        elif "registers" in line or "spill" in line:
            log(f"build: {entry}: {line.strip()}")

    # phase 3: the scan kernel against its plain version
    k200k = write_workload(WORK / "k200k", 1, 200_000, 8, 0.01)
    kernel_case("200Kbp_x8_snp1%", k200k, expect_viol=False)
    kernel_case("200Kbp_x8_snp1%_cap8", k200k, cap=8, expect_viol=True)
    sep_lst = write_workload(WORK / "ksep", 2, 5_000, 2000, 0.03, 7)
    kernel_case("separator_dense", sep_lst)
    kernel_case("identical_copies",
                write_workload(WORK / "kid", 3, 100_000, 6, 0.0))
    kernel_case("short_reference_n127",
                write_short_reference(WORK / "kshort", 4))
    lst = write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    prim = kernel_case("primary_2Mbp_x10", lst, sweep=(32768, 131072))

    # phase 4: the dense kernels against their plain versions
    dense = {}
    for name, klst in (
            ("primary_2Mbp_x10", lst),
            ("200Kbp_x8_Nrun", write_workload(WORK / "knrun", 5, 200_000, 8,
                                              0.01, n_run=64)),
            ("separator_dense", sep_lst)):
        xk, ck = load_inputs(str(klst))
        for k, r in dense_kernel_case(name, xk, ck.sx).items():
            dense.setdefault(k, []).append(r)
        del xk, ck
        torch.cuda.empty_cache()
    log(f"lcp_lift at primary: rho rows, lmax from the stats "
        f"{dense['lcp_lift'][0]['ms']:.3f} ms; rho_pad rows, lmax read back "
        f"{dense['lcp_lift_rho_pad'][0]['ms']:.3f} ms")
    nb_cases = neighbor_cases()
    torch.cuda.empty_cache()
    oracle = reference_outputs(lst)

    # phase 5: the jump slice through the CLI, kernel launches counted
    paths = []  # (backend, tag, CLI runs, launch counts, block tries, merge)

    def reset_counts():
        kernels.reset_launch_counts()
        js.REFERENCE_CALLS["lift_pairs"] = 0
        md.REFERENCE_CALLS["neighbors_reference"] = 0
        mj.REFERENCE_CALLS["ms_jump_scan_reference"] = 0

    def check_counts(backend, tag, runs, mine, tries=None, engine="host"):
        """The launch counts since reset_counts(): each kernel of ``mine``
        launched, no other, no plain version; recorded as a path."""
        counts = dict(kernels.LAUNCHES)
        plain = {**js.REFERENCE_CALLS, **md.REFERENCE_CALLS,
                 **mj.REFERENCE_CALLS}
        log(f"slice[{tag}]: kernel launches {counts}; plain calls {plain}"
            + (f"; block tries {tries}" if tries is not None else "")
            + f"; merge {engine}")
        if any(plain.values()):
            fail(f"{tag}: a plain version ran on the card's main path")
        if any(counts[k] < 1 for k in mine) or any(
                c for k, c in counts.items() if k not in mine):
            fail(f"{tag}: kernel launches {counts}, expected "
                 f"{list(mine) or 'none'}")
        if tries is not None and not (counts["lcp_lift"]
                                      == counts["dense_neighbors"] == tries):
            fail(f"{tag}: the dense kernels did not carry every block try "
                 f"({tries} tries)")
        paths.append((backend, tag, runs, counts, tries, engine))
        return counts

    def run_cli(backend: str | None, tag: str, extra=(),
                formats=(False, True), inp=lst, want=oracle, blocks=None,
                merge="device", launched=True, want_merge=None) -> dict:
        """The CLI on ``inp`` in each format with ``--merge-backend
        merge``, bytes held to ``want`` (the reference tool's) unless it is
        None; the kernel launches and plain calls counted from 0 over these
        runs: each kernel of the route (ROUTE_KERNELS) launched, unless
        ``launched`` is False, and no other. ``backend`` None passes no
        --backend (the default, auto): the backend each .log names is the
        route. The merge engine that ran, read from each .log, must be
        ``want_merge`` (default: the host merge for --merge-backend host
        and the device, native and host backends, else the device
        merge)."""
        reset_counts()
        tries0 = len(blocks.tries) if blocks else 0
        engines, ran = set(), set()
        for rle in formats:
            out = WORK / f"port_{tag}{'_rle' if rle else ''}"
            argv = [str(inp), "-o", str(out), "--device", "cuda",
                    "--merge-backend", merge, *extra] + (
                        ["--backend", backend] if backend else []) + (
                        ["-r"] if rle else [])
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                fail(f"cli ({tag}) returned non-zero")
            wall = time.perf_counter() - t0
            fmt = "rle" if rle else "plain"
            text = out.with_suffix(".log").read_text()
            engines.add("host" if "\nhead_fixup: " in text else
                        "sharded" if "\nmerge_sharded: " in text else
                        "device")
            ran.add(re.search(r"^backend: (\w+)$", text, re.M).group(1))
            if backend == "native" and "scan_engine: native" not in text:
                fail(f"{tag}: the .log does not name the native scan engine")
            phases = json.dumps(phases_from_log(out.with_suffix(".log")))
            if want is None:
                log(f"slice[{tag},{fmt}]: wall {wall:.2f} s; phases ms "
                    + phases)
                continue
            got = out.with_suffix(".rl_bwt" if rle else ".bwt").read_bytes()
            if got != want[rle]:
                fail(f"{tag}: {'rl_bwt' if rle else 'bwt'} differs from "
                     f"the reference tool's ({len(got)} vs "
                     f"{len(want[rle])} bytes)")
            log(f"slice[{tag},{fmt}]: bytes equal to the reference tool's "
                f"({len(got)} bytes); wall {wall:.2f} s; phases ms "
                + phases)
        if len(ran) != 1 or (backend and ran != {backend}):
            fail(f"{tag}: the .log names the backends {sorted(ran)}")
        backend = ran.pop()
        if want_merge is None:
            want_merge = ("host" if merge == "host" or backend in (
                "device", "native", "host") else
                "sharded" if merge == "sharded" else "device")
        engine = "/".join(sorted(engines))
        if engine != want_merge:
            fail(f"{tag}: the {engine} merge ran, expected {want_merge}")
        return check_counts(
            backend, tag, len(formats),
            ROUTE_KERNELS[backend] if launched else (),
            len(blocks.tries) - tries0 if blocks else None, engine)

    run_cli("jump", "jump")

    # heads at two lane counts against the native scan
    x_aug, coll = load_inputs(str(lst))
    t0 = time.perf_counter()
    nat = native_heads(x_aug, coll)
    log(f"oracle: native scan h={len(nat[0])} "
        f"({time.perf_counter() - t0:.2f} s)")

    def check_heads(res, what):
        h = res.h
        got = [a[:h].cpu().numpy() if torch.is_tensor(a) else a[:h]
               for a in (res.head_t, res.head_pos, res.head_len,
                         res.head_smaller, res.head_char)]
        if h != len(nat[0]) or any(
                not np.array_equal(g.astype(w.dtype), w)
                for g, w in zip(got, nat)):
            fail(f"heads of {what} differ from the native scan "
                 f"(h={h} vs {len(nat[0])})")
        log(f"heads[{what}]: h={h} equal to the native scan")

    for lanes in (4096, 32768):
        check_heads(mj.ms_jump_heads(x_aug, coll.sx, "cuda", lanes=lanes),
                    f"jump lanes={lanes}")

    # the host merge against the device merge on the jump scan's heads
    from cmsbwt_tpu_torch.engine.device_merge import \
        merge_heads_device_resident
    jres = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
    times = {"device": [], "host": []}
    for turn in ("device", "host", "host", "device"):
        if turn == "host":
            res, stages, ms = host_merge(x_aug, jres, coll.d, coll.sn, False)
            host = (res.run_len, res.run_char, res.counter)
            log(f"merge[primary]: host {ms:.1f} ms (h={jres.h}); stages ms "
                + json.dumps(stages))
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dev = merge_heads_device_resident(jres, coll.d, False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            log(f"merge[primary]: device {ms:.1f} ms")
        times[turn].append(ms)
    want_runs = normalized_runs(host[0], host[1])
    if not (np.array_equal(dev[0], want_runs[0])
            and np.array_equal(dev[1], want_runs[1])
            and np.array_equal(dev[2], host[2])):
        fail("the host merge's (run_len, run_char, counter) differ from the "
             "device merge's at primary")
    log(f"merge[primary]: host and device (run_len, run_char, counter) "
        f"equal ({len(dev[0])} runs, {len(host[0])} before normalising); "
        f"host ms {times['host']}, device ms {times['device']}")
    del jres, host, dev, want_runs

    # phase 6: the dense slice through the CLI, kernel launches counted
    run_cli("dense", "dense")
    os.environ["CMSBWT_PROFILE"] = "1"
    log("dense stages (device-synced marks, stderr):")
    try:
        check_heads(md.ms_dense_heads_on_device(x_aug, coll.sx, "cuda"),
                    "dense")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()

    # the routes that end in the host merge, at primary
    run_cli("device", "device", merge="auto")
    run_cli("native", "native", merge="auto")
    run_cli("jump", "jump_host", merge="host")
    run_cli("dense", "dense_host", merge="host")
    os.environ["CMSBWT_SN_BOUND"] = "4000000"
    try:
        with BlockLog(md) as snb:
            run_cli("dense", "dense_sn_bound", merge="auto", blocks=snb,
                    want_merge="host")
    finally:
        del os.environ["CMSBWT_SN_BOUND"]
    starts = sorted({t["b0"] for t in snb.tries})
    log(f"sn_bound[primary, CMSBWT_SN_BOUND=4000000]: {len(snb.tries)} "
        f"block tries over 2 runs, blocks at {starts}")
    if starts != list(range(0, coll.sn, 2_000_000)):
        fail("the int64 route did not scan 2 M-char blocks")
    torch.cuda.empty_cache()
    for k, r in block_kernel_case("primary_sn_bound_blocks", x_aug, coll.sx,
                                  snb.tries[0]).items():
        dense[k].append(r)
    small = write_workload(WORK / "small", 7, 30_000, 8, 0.01)
    run_cli("host", "host_small", merge="auto", inp=small,
            want=reference_outputs(small, "ref_small"))
    torch.cuda.empty_cache()

    # phase 7: the blocked dense scan at the primary shape
    bc = 4 << 20
    with BlockLog(md) as blk:
        run_cli("dense", "dense_blocked", ["--block-chars", str(bc)],
                blocks=blk)
    log(f"blocked[primary]: block_chars={bc} tries per run "
        f"{len(blk.tries) // 2} retries {blk.retries}; blocks "
        + json.dumps(blk.tries[:len(blk.tries) // 2]))
    check_heads(md.ms_dense_heads_blocked_on_device(x_aug, coll.sx, "cuda",
                                                    bc), "dense blocked")
    torch.cuda.empty_cache()
    for k, r in block_kernel_case("primary_4Mi_blocks", x_aug, coll.sx,
                                  blk.tries[0]).items():
        dense[k].append(r)
    torch.cuda.empty_cache()
    os.environ["CMSBWT_HBM_GB"] = "2"
    try:
        choice = md.dense_block_chars(len(x_aug), coll.sn,
                                      md.dense_budget("cuda"))
        log(f"guard: CMSBWT_HBM_GB=2 at primary (sn={coll.sn}) -> "
            f"block_chars={choice}")
        with BlockLog(md) as guard:
            run_cli("dense", "dense_guard", formats=(False,), blocks=guard)
    finally:
        del os.environ["CMSBWT_HBM_GB"]
    starts = sorted({t["b0"] for t in guard.tries})
    if choice is None or starts != list(range(0, coll.sn, choice)):
        fail(f"the guard's blocks {starts} are not those of its choice "
             f"{choice}")
    x2, c2 = load_inputs(str(k200k))
    with BlockLog(md) as tiny:
        res = md.ms_dense_heads_blocked_on_device(x2, c2.sx, "cuda",
                                                  1 << 16, 4)
    ref = md.ms_dense_heads_on_device(x2, c2.sx, "cuda")
    log(f"retry[200Kbp_x8, block_chars=65536, ctx=4]: "
        f"{len(tiny.tries)} tries, {tiny.retries} retries, h={res.h}")
    if not tiny.retries:
        fail("the 4-char context did not make any block retry")
    if not same_heads(res, ref) or not all(
            torch.equal(getattr(res, k), getattr(ref, k))
            for k in ("ref_sa", "ref_isa", "ref_bwt")):
        fail("the retried blocks' heads differ from the unblocked scan's")
    del res, ref, x2, c2
    ck = ["--block-chars", str(bc), "--checkpoint-dir", str(WORK / "ckpt")]
    with BlockLog(md) as ck1:
        run_cli("dense", "dense_ckpt_first", ck, formats=(False,),
                blocks=ck1)
    saved = sorted(p.name.split(".")[0] for p in (WORK / "ckpt").iterdir())
    log(f"checkpoint: saved {saved}")
    if "dense_heads" not in saved:
        fail("the checkpointed run saved no dense_heads bundle")
    with BlockLog(md) as ck2:
        run_cli("dense", "dense_ckpt_again", ck, formats=(False,),
                blocks=ck2, launched=False)
    if ck2.tries or not ck1.tries:
        fail("the checkpointed rerun scanned again")
    torch.cuda.empty_cache()

    # phase 8: 500 Mchars, above the card, blocks chosen by the guard
    t0 = time.perf_counter()
    big = write_workload(WORK / "ecoli_rle", 42, 5_000_000, BIG_DOCS, 0.01)
    log(f"big: wrote 5 Mbp x {BIG_DOCS} docs in "
        f"{time.perf_counter() - t0:.1f} s")
    kept = {}
    scan = md.ms_dense_heads_blocked_on_device

    def keep(*a, **kw):
        kept["res"] = scan(*a, **kw)
        return kept["res"]

    md.ms_dense_heads_blocked_on_device = keep
    os.environ["CMSBWT_PROFILE"] = "1"
    log("big: per-block stage marks (device-synced, stderr)")
    try:
        with BlockLog(md) as bl:
            t0 = time.perf_counter()
            run_cli("dense", "dense_500M", ["--no-rle-quirk"],
                    formats=(True,), inp=big, want=None, blocks=bl)
            wall = time.perf_counter() - t0
    finally:
        del os.environ["CMSBWT_PROFILE"]
        md.ms_dense_heads_blocked_on_device = scan
    sys.stderr.flush()
    xb, cb = load_inputs(str(big))
    unblocked = md.DENSE_BYTES_PER_CHAR * (bucket_size(len(xb))
                                           + bucket_size(cb.sn + 1))
    log(f"big: n={len(xb)} sn={cb.sn} unblocked need {unblocked} B; "
        f"{len(bl.tries)} block tries, {bl.retries} retries; wall "
        f"{wall:.2f} s; run peak {bl.run_peak} B (outside the blocks: "
        f"{bl.gap_peak} B); blocks "
        + json.dumps(bl.tries))
    if "res" not in kept or len(bl.tries) < 2:
        fail("the 500 Mchar run did not go through guard-chosen blocks")
    dres = kept.pop("res")
    t0 = time.perf_counter()
    jres = mj.ms_jump_heads(xb, cb.sx, "cuda")
    log(f"big: jump heads h={jres.h} ({time.perf_counter() - t0:.2f} s); "
        f"blocked dense heads h={dres.h} irreducible={dres.irreducible}")
    if not same_heads(dres, jres):
        fail("the 500 Mchar blocked heads differ from the jump scan's")
    del jres
    torch.cuda.empty_cache()
    # the host merge on the same heads, against the device merge's output
    from cmsbwt_tpu_torch.io import native
    res, stages, ms = host_merge(xb, dres, cb.d, cb.sn, False)
    del dres
    torch.cuda.empty_cache()
    host_out = WORK / "host_merge_500M.rl_bwt"
    if not native.write_rle_native(str(host_out), res.run_len, res.run_char):
        fail("the native RLE writer could not be built")
    del res
    same = filecmp.cmp(host_out, WORK / "port_dense_500M_rle.rl_bwt",
                       shallow=False)
    log(f"big: host merge {ms:.1f} ms; stages ms {json.dumps(stages)}; "
        f".rl_bwt equal to the device merge's: {same}")
    if not same:
        fail("the 500 Mchar host merge's .rl_bwt differs from the device "
             "merge's")
    host_out.unlink()
    for k, r in block_kernel_case("500M", xb, cb.sx, bl.tries[0]).items():
        dense[k].append(r)
    torch.cuda.empty_cache()
    hist = rle_histogram(WORK / "port_dense_500M_rle.rl_bwt")
    want_hist = np.bincount(cb.sx, minlength=256)
    if int(hist.sum()) != cb.sn or not np.array_equal(hist, want_hist):
        fail(f"the 500 Mchar .rl_bwt decodes to {int(hist.sum())} chars "
             f"(sn {cb.sn}) or another byte histogram")
    log(f"big: .rl_bwt decodes to sn={cb.sn} chars with the collection's "
        "byte histogram")
    del xb, cb

    # phase 9: auto, the model API, ms_dense and --parallel
    phase9(run_cli, check_counts, reset_counts, check_heads, paths, lst,
           oracle, k200k, x_aug, coll)

    # phase 10: the mesh modules on the card's ranks
    phase10(run_cli, check_counts, reset_counts, lst, x_aug, coll)

    def row(name, source, replaces, res):
        # every run of a route that launches this kernel, and the routes
        # that launch none (their 0 shown)
        runs = [(tag, k, c[name], t, e) for r, tag, k, c, t, e in paths
                if name in ROUTE_KERNELS[r] or not ROUTE_KERNELS[r]]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c for _, _, c, _, _ in runs),
                "launches_by_run": [
                    {"run": tag, "cli_runs": k, "launches": c,
                     "block_tries": t, "merge": e}
                    for tag, k, c, t, e in runs],
                "max_abs_err": max(r["err"] for r in res),
                "ms": res[0]["ms"], "plain_ms": res[0]["plain_ms"],
                "bound_ms": res[0]["bound_ms"], "bound_by": "bytes",
                "library_ms": None}

    log(f"smoke: every phase passed in "
        f"{time.perf_counter() - started:.1f} s")
    csrc = "cmsbwt_tpu_torch/kernels/csrc/"
    log(json.dumps({"kernels": [
        row("ms_jump_scan", csrc + "ms_jump_scan.cu",
            "docs/retired_pallas_scan.py:525", [prim]),
        row("lcp_lift", csrc + "lcp_lift.cu",
            "cmsbwt_tpu/ops/joint_sa.py:429",
            dense["lcp_lift"] + dense["lcp_lift_rho_pad"]),
        row("dense_neighbors", csrc + "dense_neighbors.cu",
            "cmsbwt_tpu/ops/ms_dense.py:366",
            dense["dense_neighbors"] + nb_cases)]}))
    log(f"device: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
