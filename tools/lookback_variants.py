"""Where the single-pass merge kernels spend their time, on one CUDA card.

    python3 tools/lookback_variants.py [primary|500M]

Builds variants of this tree's tail_good_join.cu, run_merge.cu (its two
kernels, bucket_sums and run_merge) and running_fill.cu, each a text edit
of the committed sources (tile_scan.cuh included), with the port's nvcc
flags, then runs one device merge of the jump scan's heads at the shape
(default 500M: 5 Mbp x 100 docs at 1% SNP, seed 42) and times every
variant on the inputs that merge gave the kernels (CUDA events, 5
launches, two rounds; tail_good_join and run_merge read their counts back
as the port's wrappers do; bucket_sums on outputs and scratch made
outside the events; running_fill alone on each of the merge's fills and
at 2^29 + 1 int64 rows, forward max and reverse min), beside the
committed kernel's outputs:

* ``committed`` — the sources as they are;
* ``tile2048`` / ``tile3072`` — tail_good_join with 8 / 12 rows per
  thread (2048- / 3072-row tiles);
* ``no_min_blocks`` — tail_good_join without its launch bound of two
  blocks per SM (which caps its registers at 128);
* ``no_absorb`` — no tile of tail_good_join or bucket_sums publishes
  its inclusive state with its aggregate;
* ``no_halo`` — tail_good_join never takes a tile's prefix from the rows
  after it (every tile looks back);
* ``no_lookback`` — the look-back returns the identity at once (in
  tile_scan.cuh and running_fill.cu): a timing of the loads, scans and
  stores alone (its outputs are wrong);
* ``threads256`` / ``threads512`` — run_merge with 256 / 512 threads
  (2048- / 4096-lane tiles; committed: 1024 threads, 8192 lanes);
* ``fill_tile16k`` — running_fill on 16 KB tiles (committed: 32 KB);
* ``fill_threads128`` / ``fill_threads512`` — running_fill's 32 KB tiles
  over 128 / 512 threads (committed: 256);
* ``fill_blocks3`` — running_fill's launch bound at 3 blocks per SM
  (committed: 4);
* ``fill_absorb_all`` — every running_fill tile publishes its inclusive
  state with its aggregate, as if each hid every row before it: the time
  a tile would take with no look-back chain (outputs wrong where that
  does not hold);
* ``bs_threads512`` / ``bs_items8`` — bucket_sums with 512 threads (one
  block an SM: 8192-lane tiles) / 8 lanes a thread (2048-lane tiles;
  committed: 256 x 16, three blocks an SM);
* ``bs_blocks2`` / ``bs_blocks4`` — bucket_sums at two blocks an SM
  (registers capped at 128, a stage of 8192 ranks) / four (64);
* ``bs_no_halo`` — bucket_sums' tiles always look back (the committed
  kernel takes a tile's prefix from the 32 lanes before it when a
  segment starts there);

Prints the card's name and power limit, each variant's registers and
spills (nvcc -Xptxas=-v), then one line per variant, kernel, input and
round: ms and whether the outputs equal the committed kernel's. Works in
_profile_work/ (gitignored) and deletes it."""
from __future__ import annotations

import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (also blocks JAX imports)

CSRC = ROOT / "cmsbwt_tpu_torch" / "kernels" / "csrc"
WORK = ROOT / "_profile_work"
NO_LOOKBACK = [("tile_scan.cuh", "  __shared__ S slot;\n",
                "  if (t >= 0) return Op::identity();\n"
                "  __shared__ S slot;\n")]
FILL = "running_fill.cu"
RM = "run_merge.cu"
VARIANTS = {
    "committed": [],
    "tile2048": [("tail_good_join.cu", "constexpr int ITEMS = 16;",
                  "constexpr int ITEMS = 8;")],
    "tile3072": [("tail_good_join.cu", "constexpr int ITEMS = 16;",
                  "constexpr int ITEMS = 12;")],
    "no_min_blocks": [("tail_good_join.cu",
                       "__launch_bounds__(THREADS, 2)",
                       "__launch_bounds__(THREADS)")],
    "no_absorb": [("tail_good_join.cu",
                   "return y.t_row != NONE && y.e_row != NONE;",
                   "return false;"),
                  ("run_merge.cu", "    return y.reset != 0;",
                   "    return false;")],
    "no_halo": [("tail_good_join.cu", "  const bool known = (pre.t_row",
                 "  const bool known = false && (pre.t_row")],
    "no_lookback": NO_LOOKBACK,
    "threads256": [("run_merge.cu", "constexpr int RM_THREADS = 1024;",
                    "constexpr int RM_THREADS = 256;")],
    "threads512": [("run_merge.cu", "constexpr int RM_THREADS = 1024;",
                    "constexpr int RM_THREADS = 512;")],
    "fill_tile16k": [(FILL, "constexpr int TILE_BYTES = 32768;",
                      "constexpr int TILE_BYTES = 16384;")],
    "fill_threads128": [(FILL, "constexpr int THREADS = 256;",
                         "constexpr int THREADS = 128;")],
    "fill_threads512": [(FILL, "constexpr int THREADS = 256;",
                         "constexpr int THREADS = 512;")],
    "fill_blocks3": [(FILL, "constexpr int MIN_BLOCKS = 4;",
                      "constexpr int MIN_BLOCKS = 3;")],
    "fill_absorb_all": [(FILL, "bool absorbs(const T&) { return false; }",
                         "bool absorbs(const T&) { return true; }")],
    "bs_threads512": [(RM, "constexpr int BS_THREADS = 256;",
                       "constexpr int BS_THREADS = 512;"),
                      (RM, "constexpr int BS_MIN_BLOCKS = 3;",
                       "constexpr int BS_MIN_BLOCKS = 1;")],
    "bs_items8": [(RM, "constexpr int BS_ITEMS = 16;",
                   "constexpr int BS_ITEMS = 8;")],
    "bs_blocks2": [(RM, "constexpr int BS_MIN_BLOCKS = 3;",
                    "constexpr int BS_MIN_BLOCKS = 2;"),
                   (RM, "constexpr int BS_RANKS = 4096;",
                    "constexpr int BS_RANKS = 8192;")],
    "bs_blocks4": [(RM, "constexpr int BS_MIN_BLOCKS = 3;",
                    "constexpr int BS_MIN_BLOCKS = 4;")],
    "bs_no_halo": [(RM, "      halo_known = lo > 0 && st != 0u;",
                    "      halo_known = false;")],
}
STEMS = ("tail_good_join", "run_merge", "running_fill")
SHAPES = {"primary": (2_000_000, 10), "500M": (5_000_000, cs.BIG_DOCS)}


def build(kernels) -> dict:
    """Every variant's libraries (the committed tree's three, a variant's
    those whose sources it edits), built by parallel nvcc processes."""
    jobs = {}
    for name, edits in VARIANTS.items():
        d = WORK / name
        shutil.copytree(CSRC, d)
        for f, old, new in edits:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name}: {f} no longer has "
                                 f"{old!r}")
            (d / f).write_text(text.replace(old, new))
        files = {f for f, _, _ in edits}
        stems = [st for st in STEMS if not edits or f"{st}.cu" in files
                 or "tile_scan.cuh" in files]
        for stem in stems:
            jobs[name, stem] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                 str(d / f"lib{stem}.so"), str(d / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for (name, stem), proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}/{stem}.cu:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
        print(f"lookback_variants: {name}/{stem}.cu registers per kernel "
              f"{regs}, spill stores {spills} B", flush=True)
        lib = ctypes.CDLL(str(WORK / name / f"lib{stem}.so"))
        f = getattr(lib, f"{stem}_scratch_bytes")
        f.restype, f.argtypes = LL, ([LL, I] if stem == "running_fill"
                                     else [I])
        f = getattr(lib, f"{stem}_launch")
        f.restype = I
        f.argtypes = {"tail_good_join": [P, P, P, P, I, P, P, P, I, P, P, P],
                      "run_merge": [P] * 3 + [I] + [P] * 4,
                      "running_fill": [P, P, LL, I, I, I, P, P]}[stem]
        if stem == "run_merge":
            lib.bucket_sums_scratch_bytes.restype = LL
            lib.bucket_sums_scratch_bytes.argtypes = [I]
            lib.bucket_sums_launch.restype = I
            lib.bucket_sums_launch.argtypes = [P, P, P, I, I, I] + [P] * 5
        libs[name, stem] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("lookback_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    shape = sys.argv[1] if len(sys.argv) > 1 else "500M"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        kernels.load()
        libs = build(kernels)
        ref_len, docs = SHAPES[shape]
        lst = cs.write_workload(WORK / "data", 42, ref_len, docs, 0.01)
        x_aug, coll = load_inputs(str(lst))
        res = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
        del x_aug
        with cs.MergeCapture() as cap:
            dm.merge_heads_device_resident(res, coll.d, False,
                                           want_counter=False)
        del res
        torch.cuda.empty_cache()
        k1s, k2fs, i_s, pay_s, h_pad = cap.join
        k_s, len_s, chr_s = cap.runs
        J, L = k1s.numel(), k_s.numel()
        ptr = lambda a: ctypes.c_void_p(a.data_ptr())
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        i32 = dict(dtype=torch.int32, device="cuda")

        def join(lib):
            counter = torch.zeros(h_pad + 2, **i32)
            ekey, f_cls = torch.empty(J, **i32), torch.empty(J, **i32)
            stats = torch.zeros(2, dtype=torch.int64, device="cuda")
            scratch = torch.zeros(int(lib.tail_good_join_scratch_bytes(J)),
                                  dtype=torch.uint8, device="cuda")
            if lib.tail_good_join_launch(
                    ptr(k1s), ptr(k2fs), ptr(i_s), ptr(pay_s), J,
                    ptr(f_cls), ptr(ekey), ptr(counter), h_pad + 2,
                    ptr(stats), ptr(scratch), stream):
                raise SystemExit("tail_good_join launch failed")
            stats.tolist()   # the wrapper reads the counts back
            return counter, ekey, f_cls, stats

        def runs(lib):
            out_len, out_chr = torch.empty(L, **i32), torch.empty(
                L, dtype=torch.uint8, device="cuda")
            scratch = torch.zeros(int(lib.run_merge_scratch_bytes(L)),
                                  dtype=torch.uint8, device="cuda")
            if lib.run_merge_launch(ptr(k_s), ptr(len_s), ptr(chr_s), L,
                                    ptr(out_len), ptr(out_chr),
                                    ptr(scratch), stream):
                raise SystemExit("run_merge launch failed")
            n = int(scratch[4:8].view(torch.int32).item())  # the run count
            return out_len[:n], out_chr[:n]

        br, bid, m_c, nec, n_pad = cap.sums
        sum_outs = [torch.zeros(n_pad, **i32), torch.zeros(n_pad, **i32),
                    torch.zeros(br.numel(), **i32)]

        def sums(lib, scratch=None):
            timed = scratch is not None
            if not timed:
                scratch = torch.zeros(int(lib.bucket_sums_scratch_bytes(
                    nec)), dtype=torch.uint8, device="cuda")
            if lib.bucket_sums_launch(ptr(br), ptr(bid), ptr(m_c), nec,
                                      br.numel(), n_pad, *map(ptr, sum_outs),
                                      ptr(scratch), stream):
                raise SystemExit("bucket_sums launch failed")
            return None if timed else [o.clone() for o in sum_outs]

        # running_fill: every fill of the merge, then 2^29 + 1 int64 rows
        fills = [(f"fill{i}", v, op, rev)
                 for i, (v, op, rev) in enumerate(cap.fills)]
        big = cs.fill_input(cs.BIG_FILL, torch.int64, 9, 5)
        fills += [("int64_big_max", big, "max", False),
                  ("int64_big_min_reverse", big, "min", True)]
        fill_out = {}

        def fill(lib, case, scratch=None):
            _, v, op, rev = case
            m, elem = v.numel(), v.element_size()
            timed = scratch is not None
            if not timed:
                scratch = torch.zeros(int(lib.running_fill_scratch_bytes(
                    m, elem)), dtype=torch.uint8, device="cuda")
            out = fill_out.setdefault(id(v), torch.empty_like(v))
            if lib.running_fill_launch(ptr(v), ptr(out), m, elem,
                                       int(op == "min"), int(rev),
                                       ptr(scratch), stream):
                raise SystemExit("running_fill launch failed")
            return None if timed else [out.clone()]

        def alone(scratch_bytes, fn):
            return cs.alone_ms(lambda sc: fn(sc), scratch_bytes)

        kinds_of = {
            "tail_good_join": lambda lib: [
                ("tail_good_join", lambda: join(lib), None)],
            "run_merge": lambda lib: [
                ("run_merge", lambda: runs(lib), None),
                ("bucket_sums", lambda: sums(lib), (
                    int(lib.bucket_sums_scratch_bytes(nec)),
                    lambda sc: sums(lib, sc)))],
            "running_fill": lambda lib: [
                (f"running_fill[{c[0]}]", lambda c=c: fill(lib, c), (
                    int(lib.running_fill_scratch_bytes(c[1].numel(),
                                                       c[1].element_size())),
                    lambda sc, c=c: fill(lib, c, sc))) for c in fills]}
        want = {}
        for stem in STEMS:
            for kernel, fn, _ in kinds_of[stem](libs["committed", stem]):
                want[kernel] = fn()
        print(f"lookback_variants[{shape}]: J={J} join rows, L={L} lanes, "
              f"fills {[c[1].numel() for c in fills]}", flush=True)
        for rnd in range(2):
            for (name, stem), lib in libs.items():
                for kernel, fn, lone in kinds_of[stem](lib):
                    got = fn()
                    torch.cuda.synchronize()
                    same = all(a.shape == b.shape and torch.equal(a, b)
                               for a, b in zip(got[:3], want[kernel][:3]))
                    del got
                    # the kernel alone where its scratch can be made
                    # beforehand (outputs made once, outside the events)
                    ms = (alone(*lone) if lone else cs.cuda_ms(fn, 5))
                    print(f"lookback_variants[{shape}] round {rnd} {name} "
                          f"{kernel}: {ms:.3f} ms; outputs equal: {same}",
                          flush=True)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
