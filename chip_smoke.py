"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last line is printed only when
every phase passed):

1. device  — require CUDA; print the card's name and power limit.
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
   seed) and on a separator-dense case. Tolerance: exact equality.
5. jump slice — the port's CLI (jump scan + device merge, --device cuda)
   on the bench's primary workload (2 Mbp reference x 10 docs at 1% SNP,
   about 20 Mchars), plain and -r. Outputs must be byte-equal to the C++
   reference tool's (baseline/cms-bwt-ref, run on the same input list),
   the scan's heads equal to those of the native C++ PLCP-skip scan
   (native/cmsbwt_scan.cpp, built here with g++) at 4096 and 32768 lanes,
   and the CUDA kernel must have carried the scan.
6. dense slice — the same CLI with --backend dense --merge-backend device
   on the same workload, plain and -r: bytes equal to the reference
   tool's, the dense scan's heads equal to the native scan's, and the
   lcp_lift and dense_neighbors kernels (not their plain versions) must
   have carried it. Prints the .log phases and the dense stage split.

Imports nothing of JAX or of the JAX package (an import hook refuses
``jax``, ``jaxlib`` and ``cmsbwt_tpu``, so the port is shown to stand
alone): its oracles are the two C++ programs above.

The kernels line gives, per kernel, its time at the primary shape (CUDA
events), its plain version's, its launches on the main path (the CLI run
plain and -r) and per CLI run, and bound_ms: the bytes the function must
move at these inputs (each input read once, each output written once; for
gathers, the entries this run's data touches) over 3.35 TB/s, the H100
SXM's memory rate. No single PyTorch call computes any of the three
functions, so library_ms is null.
"""
from __future__ import annotations

import ctypes
import importlib.abc
import json
import os
import pathlib
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


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


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


def dense_kernel_case(name, lst, reps=5):
    """The CUDA lcp_lift and dense_neighbors against lift_pairs and
    neighbors_reference on the card, fed the port's own dense stages on
    ``lst`` (as ms_dense_heads_on_device runs them); returns
    {kernel: result dict}."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    x_aug, coll = load_inputs(str(lst))
    n, sn = len(x_aug), coll.sn
    b, sp, wide, n_pad, _, m = md.joint_string(x_aug, coll.sx, "cuda")
    sa, isa, hist, packs, _, split_lv = js.joint_suffix_array(b, sp, m, wide)
    stats, ai, bi, lv = md._irreducible_slots(b, sp, sa, isa, split_lv, n,
                                              sn, m, n_pad)
    rho = int(stats[0])
    rows = min(md._pow2_pad(rho), m)
    ai, bi, lv = ai[:rows], bi[:rows], lv[:rows]
    out = {}

    def compare(kernel, plain, cuda_fn, plain_fn, what, moved):
        want = plain_fn()
        got = cuda_fn()
        torch.cuda.synchronize()
        if any(a.dtype != b.dtype or a.shape != b.shape
               for a, b in zip(want, got)):
            fail(f"{kernel}[{name}]: dtype or shape differs from {plain}")
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(want, got))
        ms = cuda_ms(cuda_fn, reps)
        plain_ms = cuda_ms(plain_fn, 2)
        bound = bound_ms(moved)
        log(f"kernel {kernel}[{name}]: {what} max_abs_err={err} "
            f"(tolerance {TOL}) cuda_ms={ms:.3f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound:.4f}")
        if err > TOL:
            fail(f"{kernel}[{name}]: CUDA kernel disagrees with {plain}")
        out[kernel] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
        return want

    h = compare("lcp_lift", "lift_pairs",
                lambda: (kernels.lcp_lift_cuda(hist, packs, ai, bi, lv, m),),
                lambda: (js.lift_pairs(hist, packs, ai, bi, lv, m),),
                f"m={m} seed={'wide' if wide else 'narrow'} rho={rho} "
                f"rows={rows}", lift_bytes(packs, ai, bi, lv, m))[0]
    ell = md._fill_ell(h, ai, isa, m)
    compare("dense_neighbors", "neighbors_reference",
            lambda: kernels.dense_neighbors_cuda(sa, ell, n, m),
            lambda: md.neighbors_reference(sa, ell, n, m),
            f"m={m} ref_slots={n}", 24 * m)   # sa, ell in; 4 int32 rows out
    return out


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


def reference_outputs(lst: pathlib.Path) -> dict:
    """.bwt and .rl_bwt bytes of the C++ reference tool on ``lst``."""
    if not REF_BIN.exists():
        fail(f"reference tool {REF_BIN.relative_to(ROOT)} is missing")
    out = {}
    for rle in (False, True):
        base = WORK / ("ref_rle" if rle else "ref")
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


def main() -> int:
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
    try:
        return run_phases(card, kind)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


def run_phases(card: str, kind: str) -> int:
    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import joint_sa as js
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops import ms_jump as mj

    # phase 2: build
    kernels.load()
    log(f"build: {kernels.BUILD['seconds']:.2f} s -> {kernels.BUILD['path']}")
    for line in kernels.BUILD["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    # phase 3: the scan kernel against its plain version
    lst = write_workload(WORK / "k200k", 1, 200_000, 8, 0.01)
    kernel_case("200Kbp_x8_snp1%", lst, expect_viol=False)
    kernel_case("200Kbp_x8_snp1%_cap8", lst, cap=8, expect_viol=True)
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
        for k, r in dense_kernel_case(name, klst).items():
            dense.setdefault(k, []).append(r)
        torch.cuda.empty_cache()
    oracle = reference_outputs(lst)

    # phase 5: the jump slice through the CLI, kernel launches counted
    def run_cli(backend: str, tag: str) -> dict:
        kernels.reset_launch_counts()
        js.REFERENCE_CALLS["lift_pairs"] = 0
        md.REFERENCE_CALLS["neighbors_reference"] = 0
        mj.REFERENCE_CALLS["ms_jump_scan_reference"] = 0
        for rle in (False, True):
            out = WORK / f"port_{tag}{'_rle' if rle else ''}"
            argv = [str(lst), "-o", str(out), "--device", "cuda",
                    "--backend", backend, "--merge-backend", "device"] \
                + (["-r"] if rle else [])
            t0 = time.perf_counter()
            if cli.main(argv) != 0:
                fail(f"cli ({backend}) returned non-zero")
            wall = time.perf_counter() - t0
            got = out.with_suffix(".rl_bwt" if rle else ".bwt").read_bytes()
            if got != oracle[rle]:
                fail(f"{backend}: {'rl_bwt' if rle else 'bwt'} differs from "
                     f"the reference tool's ({len(got)} vs "
                     f"{len(oracle[rle])} bytes)")
            log(f"slice[{backend},{'rle' if rle else 'plain'}]: bytes equal "
                f"to the reference tool's ({len(got)} bytes); wall "
                f"{wall:.2f} s; phases ms " + json.dumps(phases_from_log(
                    out.with_suffix(".log"))))
        counts = dict(kernels.LAUNCHES)
        plain = {**js.REFERENCE_CALLS, **md.REFERENCE_CALLS,
                 **mj.REFERENCE_CALLS}
        log(f"slice[{backend}]: kernel launches {counts}; plain calls "
            f"{plain}")
        if any(plain.values()):
            fail(f"{backend}: a plain version ran on the card's main path")
        return counts

    jump_counts = run_cli("jump", "jump")
    if jump_counts["ms_jump_scan"] < 1:
        fail("the CUDA ms_jump_scan did not carry the jump slice's scan")

    # heads at two lane counts against the native scan
    x_aug, coll = load_inputs(str(lst))
    t0 = time.perf_counter()
    nat = native_heads(x_aug, coll)
    log(f"oracle: native scan h={len(nat[0])} "
        f"({time.perf_counter() - t0:.2f} s)")

    def check_heads(res, what):
        h = res.h
        got = [a[:h].cpu().numpy() for a in (res.head_t, res.head_pos,
                                             res.head_len, res.head_smaller,
                                             res.head_char)]
        if h != len(nat[0]) or any(
                not np.array_equal(g.astype(w.dtype), w)
                for g, w in zip(got, nat)):
            fail(f"heads of {what} differ from the native scan "
                 f"(h={h} vs {len(nat[0])})")
        log(f"heads[{what}]: h={h} equal to the native scan")

    for lanes in (4096, 32768):
        check_heads(mj.ms_jump_heads(x_aug, coll.sx, "cuda", lanes=lanes),
                    f"jump lanes={lanes}")

    # phase 6: the dense slice through the CLI, kernel launches counted
    dense_counts = run_cli("dense", "dense")
    if dense_counts["lcp_lift"] < 1 or dense_counts["dense_neighbors"] < 1:
        fail("the CUDA lcp_lift and dense_neighbors did not carry the "
             "dense slice")
    os.environ["CMSBWT_PROFILE"] = "1"
    log("dense stages (device-synced marks, stderr):")
    try:
        check_heads(md.ms_dense_heads_on_device(x_aug, coll.sx, "cuda"),
                    "dense")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()

    def row(name, source, replaces, launches, res):
        # launches: the main path's run, the CLI plain and -r (two runs)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "launches_per_run": launches / 2,
                "max_abs_err": max(r["err"] for r in res),
                "ms": res[0]["ms"], "plain_ms": res[0]["plain_ms"],
                "bound_ms": res[0]["bound_ms"], "bound_by": "bytes",
                "library_ms": None}

    csrc = "cmsbwt_tpu_torch/kernels/csrc/"
    log(json.dumps({"kernels": [
        row("ms_jump_scan", csrc + "ms_jump_scan.cu",
            "docs/retired_pallas_scan.py:525", jump_counts["ms_jump_scan"],
            [prim]),
        row("lcp_lift", csrc + "lcp_lift.cu",
            "cmsbwt_tpu/ops/joint_sa.py:429", dense_counts["lcp_lift"],
            dense["lcp_lift"]),
        row("dense_neighbors", csrc + "dense_neighbors.cu",
            "cmsbwt_tpu/ops/ms_dense.py:366",
            dense_counts["dense_neighbors"], dense["dense_neighbors"])]}))
    log(f"device: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
