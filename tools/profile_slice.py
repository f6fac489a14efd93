"""Profile the port on one CUDA card.

    python3 tools/profile_slice.py             # jump + device-merge slice
    python3 tools/profile_slice.py --cli-only  # its step 3 alone
    python3 tools/profile_slice.py --parent DIR  # jump CLI A/B vs DIR
    python3 tools/profile_slice.py --dense     # dense + device-merge slice
    python3 tools/profile_slice.py --dense --parent DIR  # + A/B vs DIR
    python3 tools/profile_slice.py --blocked   # the blocked dense scan
    python3 tools/profile_slice.py --host-merge  # ~1 Gchar, host merge
    python3 tools/profile_slice.py --routes [SHAPE]  # jump/dense/native
    python3 tools/profile_slice.py --routes 500M --backends jump
    python3 tools/profile_slice.py --mesh      # mesh routes, every card
    python3 tools/profile_slice.py --merge-stages [SHAPE] [--parent DIR]
    python3 tools/profile_slice.py --merge-kernels [SHAPE] [--parent DIR]
    python3 tools/profile_slice.py --comp-groups  # compacted round by group size
    python3 tools/profile_slice.py --output [SHAPE] [--parent DIR] [--step0]

The jump mode, at the bench's primary shape (2 Mbp reference x 10 docs at
1% SNP), prints, each on its own lines:

1. the card's name and power limit (nvidia-smi);
2. the ms_jump_scan kernel alone at 4096 .. 131072 lanes: mean device ms
   over 5 launches (CUDA events), after one warm launch;
3. the CLI (--device cuda) at lanes 4096, 32768, 4096, 32768 in one
   process: wall seconds, the phase split of each run's .log and its peak
   device memory (torch.cuda.max_memory_allocated);
4. merge_device stage by stage (CMSBWT_PROFILE=1: device-synced marks, on
   stderr) at 32768 lanes;
5. one merge under torch.profiler: wall ms, the sum of device kernel and
   copy time, and the top operators by device time.

``--cli-only`` drives the port through its CLI alone, so a copy of this
script placed in an older checkout's tools/ measures that checkout's port
the same way. ``--parent DIR`` (an older checkout's root) instead runs the
jump CLI at the primary shape three times per process, one process per
turn, in DIR and in this tree in turns (parent, this, this, parent), and
prints every run's merge_device and other .log phases.

The dense mode prints the card's name and power limit, then at the
primary shape each dense kernel launch's device time (torch.profiler),
and with ``--parent DIR`` (an older checkout's root) that checkout's
lcp_lift and dense_neighbors against this tree's, in turns; then at the
primary shape: the CLI (--backend dense) three times in one process (wall
seconds and the .log phases), the dense scan stage by stage
(CMSBWT_PROFILE=1, device-synced marks, on stderr), and one dense scan
under torch.profiler (wall ms, device ms, top operators by device time).
Then once at the bench's ecoli_dense shape (5 Mbp x 20 docs at 1% SNP,
seed 42, about 100 Mchars, narrow seed): both dense kernels alone
against their plain versions (chip_smoke.dense_kernel_case: exact; the
lift on the rho and on the rho_pad rows), the launch split and the
parent A/B again, the CLI with -r, its bytes held
to the C++ reference tool's (baseline/cms-bwt-ref), its phases, the stage
split, the peak device memory (torch.cuda.max_memory_allocated) of the
CLI run and of the scan alone, and both per joint char.

The blocked mode prints the card's name and power limit, warms the CLI
up at the primary shape, then at the bench's ecoli_rle shape at
BENCH_FULL=1 (5 Mbp x 100 docs at 1% SNP, seed 42, ~500 Mchars, above what
the unblocked dense scan needs on an 80 GB card): the C++ reference
tool's -r run (its seconds), the CLI with -r and no --block-chars (the
memory guard chooses the blocks; per-block stage marks on stderr with
CMSBWT_PROFILE=1), then with --block-chars 33554432 (the bench's choice
above 160 Mchars, bench.py:194-197): for each, wall seconds, .log phases,
every block try (window, m, seconds, peak device bytes and per joint
char, from chip_smoke.BlockLog), the run's peak, and its bytes held to
the reference tool's. Then at ecoli_dense (5 Mbp x 20 docs), -r,
unblocked and with 32 Mi-char blocks in turns (unblocked, blocked,
blocked, unblocked): phases, peaks, block tries, bytes equal to each
other.

The host-merge mode prints the card's name and power limit, the host's
CPU model and its memory (free -g), warms the CLI up at the primary shape, then runs
the CLI once at 5 Mbp x 200 docs at 1% SNP (seed 42, ~1.0 Gchars), -r
--no-rle-quirk, above the device merge's memory ceiling: the guard
chooses the blocks and merge_backend=auto takes the host merge. It prints
the .log phases, every block try, the peak device bytes and the host's
peak RSS, with the host merge's stage marks on stderr (CMSBWT_PROFILE=1),
and checks that the .rl_bwt decodes to sn chars with the collection's
byte histogram.

The routes mode prints the card's name and power limit, warms each route
up on a small input, then at each shape of ROUTE_SHAPES (the bench's
toy_lowdiv, primary, primary at 5% and at 10% SNP, sars_stream at its
default and its BENCH_FULL prefix, the 500 Mchar ecoli_rle shape, and 200
Kbp x 8 docs) runs the CLI 3 times on each of the jump, dense and native
routes (see routes_main; ``--backends`` keeps some): wall seconds, .log
phases and the backend it names, the probe's absent fraction, and a
check that every route wrote the same bytes, then a one-line JSON
summary. The auto rule's cuda branch
(engine/pipeline.auto_backend) is read off this table.

The mesh mode (run it on a host with four cards) prints
every card's name and power limit, then, each part on its own lines and
each failure printed without stopping the next part:

1. primary (2 Mbp x 10 docs, 1%): the jump scan's heads once, the device
   merge three times, then merge_heads_sharded at R = 1, 2 and 4 ranks
   (up to the visible cards), twice each, runs equal to the device
   merge's: wall seconds, and of each run the ranks' start-up and work
   seconds and peak device bytes per rank
   (parallel/distributed.LAST_RUN); the stage marks of one run at the
   largest R on stderr (CMSBWT_PROFILE=1);
2. the giant route at toy scale: the CLI (auto) at primary under
   CMSBWT_GIANT_THRESHOLD=1000 (the sharded int64 index over R ranks, the
   native int64 scan, the host merge), its phases, bytes equal to the
   jump CLI's;
3. 500 Mchars (5 Mbp x 100 docs): the mesh scan over R ranks and the
   one-card blocked loop in the same blocks (the CLI's --parallel block,
   sn / R capped by the phrase-chunk cap and the guard), in turns (one
   card, mesh, mesh, one card), heads equal; the device merge on one card
   and the sharded merge over R ranks of the same heads, in turns, runs
   equal; then the CLI with --backend dense --parallel --merge-backend
   sharded -r --no-rle-quirk: phases, and the .rl_bwt decoding to sn
   chars with the collection's byte histogram;
4. ~1.0 Gchars (5 Mbp x 200 docs), on four cards or more: the CLI with
   --backend jump --merge-backend sharded -r --no-rle-quirk: phases, the
   sharded merge's peak device bytes per rank, rank 0's peak host RSS,
   the histogram check;

then a ``mesh summary {json}`` line.

The merge-stages mode prints the card's name and power limit, then at
the primary shape and at the 500 Mchar shape (5 Mbp x 100 docs at 1%
SNP, seed 42; ``--merge-stages primary`` or ``500M`` for one) runs one
child process a turn that imports the package from one checkout
(merge_child): this tree, or with ``--parent DIR`` (an older checkout's
root) parent, this, this, parent. Each child takes the jump scan's heads
(h, h_pad), merges once to warm up, then three merges with
head_string_sa and tail_good timed (device-synced; ``merge_run`` lines
with merge_device ms and the peak device bytes per collection char),
one merge with head_string_sa taken apart by round (each sort and rank
step, the rest, rounds, k_star, the host's reads of device values) and
tail_good in five parts (expansion, join sort, post-sort gathers,
tail_good_join, rest), one with each stage's peak device bytes
(``merge_split``), and the jump -r CLI three times (``cli_run``); this
tree alone also prints the stage marks (CMSBWT_PROFILE=1, stderr),
head_string_sa, tail_good, tail_exact and runs_emit each under its own
torch.profiler (wall and device ms, the top operators by device time),
and runs_emit's three bucket sums on that merge's lanes
(bucket_sums_case): h_pad, nec and the lanes sent to index 0, each sum
alone as the plain version's accumulating index_put_ (with and without
the pad lanes) and as Tensor.index_add_, and the bucket_sums kernel. The
tool ends with a ``merge_stages summary {json}`` line.

The merge-kernels mode runs one device merge of the jump scan's heads
per shape (primary, 500M) and holds each of the merge's kernels on the
inputs it got to its plain version (exact), timed with its bound (and
bucket_sums beside three Tensor.index_add_); running_fill and
bucket_sums are also timed alone (CUDA events around the launches only)
beside Tensor.copy_ of the same bytes, and running_fill on each of the
merge's fills beside one 1-D torch.cummax. Then running_fill at 2^29 + 1
int64 rows (``int64_big``) and on the dense scan's PLCP fill at primary
and ecoli_dense (``primary_dense``, ``ecoli_dense``; SHAPE, a comma
list, keeps some of these names). With ``--parent DIR`` (an older
checkout, e.g. ``_export/parent`` from ``git archive``) it also times
that checkout's tail_good_join, run_merge, bucket_sums and running_fill
against this tree's on the same inputs, parent, this, this, parent,
after checking that their outputs are equal.

The comp-groups mode runs dense_rank_comp's compacted round on made
slices of the 500 Mchar merge's first compacted round (9 602 118 rows of
m = 36 051 597) in groups of 2 .. 8192 rows: as committed, and with its
shared-memory sort by counting only and by the bitonic network only
(edits of sa_round.cu built beside it), each held to the plain round and
timed alone and with its wrapper, beside radix_sort of the whole slice
(the large path's sort): one ``comp_groups`` line a group size.

The output mode times the end of the device merge and the output write
at the primary and 500 Mchar shapes (``--output primary`` or ``500M`` for
one), one child process a turn that imports the package from one
checkout: this tree, or with ``--parent DIR`` parent, this, this,
parent. Each turn runs the jump CLI ``--runs`` times (default 2) per
shape with ``-r --no-rle-quirk`` and, at primary, plain too: every run's
wall seconds, .log phases and output sha1 (``cli_run`` lines), the bytes
held equal across the trees; then an ``output_ab summary {json}`` line
with every run's wall, merge_device and write_output by shape, format
and tree. ``--step0`` first runs step 0 in the parent's package (this
tree's without ``--parent``): per shape parse's three parts (the native
read and copy, io/fasta's np.nonzero of the separators,
validate_collection's masks), the jump scan's heads, one device merge to
warm up, then one whose run list it keeps as run_merge hands it back
(the list's download timed apart: the two ``.cpu()`` copies and the
int64 widening), R, the .rl_bwt's size (9 B a run), the host writer's
time on those runs (io/native.write_rle_native) and one ``f.write`` of
the .rl_bwt's bytes and of sn bytes from pinned memory (warm page cache;
nothing synced to the disk): ``step0`` lines, then the jump -r CLI once.

Each child of a turn (merge-stages, output) builds the native runtimes
into a directory of its tree's own (CMSBWT_NATIVE_DIR), so no turn loads
another tree's build. Works in _profile_work/ (gitignored) and deletes
it. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (also blocks JAX imports)

WORK = ROOT / "_profile_work"
SWEEP = (4096, 8192, 16384, 32768, 65536, 131072)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def profiled(fn, rows: int = 22) -> None:
    """Run ``fn`` once under torch.profiler; print wall and device ms and
    the top operators by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # device-side events only: an operator's row repeats its kernels' time
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA)
    print(f"profiled wall_ms={wall:.1f} device_ms={dev_us / 1e3:.1f}"
          " (wall includes the profiler's own start-up)")
    print(ka.table(sort_by="self_device_time_total", row_limit=rows,
                   max_name_column_width=48), flush=True)


def cli_run(lst, out, *flags) -> dict:
    """One CLI run on the card; returns its .log phases (ms)."""
    from cmsbwt_tpu_torch import cli
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cli.main([str(lst), "-o", str(out), "--device", "cuda", *flags]):
        raise RuntimeError("cli failed")
    wall = time.perf_counter() - t0
    phases = cs.phases_from_log(out.with_suffix(".log"))
    print(f"cli {' '.join(flags)} wall_s={wall:.3f} peak_bytes="
          f"{torch.cuda.max_memory_allocated()} phases_ms "
          + json.dumps(phases), flush=True)
    return phases


def stage_split(x_aug, sx, label: str):
    """One dense scan with CMSBWT_PROFILE=1 (stage marks on stderr)."""
    from cmsbwt_tpu_torch.ops import ms_dense as md
    print(f"dense stages ({label}, stderr):", flush=True)
    os.environ["CMSBWT_PROFILE"] = "1"
    try:
        res = md.ms_dense_heads_on_device(x_aug, sx, "cuda")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()
    return res


def parent_kernels(parent: pathlib.Path) -> dict:
    """Build an older checkout's lcp_lift.cu and dense_neighbors.cu into
    WORK with this tree's nvcc flags, bound to their C interface (the
    same as this tree's); returns {stem: ctypes handle}."""
    import ctypes
    from cmsbwt_tpu_torch import kernels
    csrc = parent / "cmsbwt_tpu_torch" / "kernels" / "csrc"
    WORK.mkdir(parents=True, exist_ok=True)
    jobs = {stem: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
         str(WORK / f"parent_{stem}.so"), str(csrc / f"{stem}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for stem in ("lcp_lift", "dense_neighbors")}
    libs = {}
    for stem, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the parent's {stem}.cu:\n"
                               + out)
        libs[stem] = ctypes.CDLL(str(WORK / f"parent_{stem}.so"))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    f = libs["lcp_lift"].lcp_lift_launch
    f.restype, f.argtypes = I, [P, P, I, P, P, P, P, I, I, I, I, I, P]
    f = libs["dense_neighbors"].dense_neighbors_scratch_bytes
    f.restype, f.argtypes = LL, [I]
    f = libs["dense_neighbors"].dense_neighbors_launch
    f.restype, f.argtypes = I, [P, P, I, I, P, P, P, P, P, P]
    return libs


def launch_split(fn, label: str, reps: int = 10) -> None:
    """Mean device time of each CUDA kernel that ``fn`` launches, over
    ``reps`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            print(f"launch split [{label}]: {name[:48]} "
                  f"us={e.device_time_total / e.count:.1f} "
                  f"calls={e.count / reps:g}", flush=True)


def dense_kernels(libs, lst, label: str, reps: int = 20) -> None:
    """This tree's dense kernels on the dense stages of ``lst``: each
    launch's device time (launch_split); then, given an older checkout's
    kernels ``libs``, those against these: outputs equal, then CUDA-event
    times over ``reps`` launches back to back, in turns (parent, this,
    this, parent). The lift is timed as each tree's main path calls it
    (parent: the rho_pad rows, lmax read back from the device; this tree:
    the rho rows, lmax from the stats), and the parent's kernel also on
    the rho rows."""
    import ctypes
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops.joint_sa import seed_level_of
    x_aug, coll = load_inputs(str(lst))
    d = cs.dense_inputs(x_aug, coll.sx)
    del x_aug, coll
    sa, isa, hist, packs = (d[k] for k in ("sa", "isa", "hist", "packs"))
    n, m, rho, lmax, rho_pad = (d[k] for k in ("n", "m", "rho", "lmax",
                                               "rho_pad"))
    sl = seed_level_of(packs)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def rows(k):
        return d["ai"][:k], d["bi"][:k], d["lv"][:k]

    def old_lift(k):
        ai, bi, lv = rows(k)
        top = int(torch.where((ai < m) & (bi < m), lv, 0).max())
        h = torch.empty(k, dtype=torch.int32, device="cuda")
        if libs["lcp_lift"].lcp_lift_launch(
                ptr(hist), ptr(packs), int(packs.shape[0]), ptr(ai), ptr(bi),
                ptr(lv), ptr(h), k, m, sl, top, kernels.LIFT_THREADS,
                stream()):
            raise RuntimeError("parent lcp_lift launch failed")
        return h

    def new_lift(k, **kw):
        return kernels.lcp_lift_cuda(hist, packs, *rows(k), m, **kw)

    h = new_lift(rho, lmax=lmax)
    ell = md._fill_ell(h, rows(rho)[0], isa, m)
    new_nb = lambda: kernels.dense_neighbors_cuda(sa, ell, n, m)
    launch_split(new_nb, f"{label}, dense_neighbors")
    launch_split(lambda: new_lift(rho, lmax=lmax), f"{label}, lcp_lift")
    if libs is None:
        return
    lib = libs["dense_neighbors"]

    def old_nb():
        scratch = torch.empty(int(lib.dense_neighbors_scratch_bytes(m)),
                              dtype=torch.uint8, device="cuda")
        outs = [torch.empty(m, dtype=torch.int32, device="cuda")
                for _ in range(4)]
        if lib.dense_neighbors_launch(ptr(sa), ptr(ell), n, m, ptr(scratch),
                                      *map(ptr, outs), stream()):
            raise RuntimeError("parent dense_neighbors launch failed")
        return outs

    same = torch.equal(old_lift(rho), h) and all(
        torch.equal(a, b) for a, b in zip(old_nb(), new_nb()))
    torch.cuda.synchronize()
    print(f"parent A/B [{label}]: m={m} rho={rho} rho_pad={rho_pad} "
          f"outputs equal: {same}", flush=True)
    if not same:
        raise RuntimeError("the parent's dense kernels disagree")
    runs = {"lcp_lift parent kernel, rho_pad rows (parent main path)":
            lambda: old_lift(rho_pad),
            "lcp_lift parent kernel, rho rows": lambda: old_lift(rho),
            "lcp_lift this kernel, rho rows (this main path)":
            lambda: new_lift(rho, lmax=lmax),
            "lcp_lift this kernel, rho_pad rows": lambda: new_lift(rho_pad)}
    for name, fn in runs.items():
        fn()
    for turn in range(4):
        for name, fn in runs.items():
            print(f"parent A/B [{label}] turn {turn}: {name} "
                  f"ms={cs.cuda_ms(fn, reps):.4f}", flush=True)
    for turn, (who, fn) in enumerate((("parent", old_nb), ("this", new_nb),
                                      ("this", new_nb),
                                      ("parent", old_nb))):
        print(f"parent A/B [{label}] turn {turn}: dense_neighbors {who} "
              f"ms={cs.cuda_ms(fn, reps):.4f}", flush=True)


def dense_main(parent: pathlib.Path | None) -> None:
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_dense as md
    kernels.load()
    libs = parent_kernels(parent) if parent else None
    lst = cs.write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    dense_kernels(libs, lst, "primary")
    torch.cuda.empty_cache()
    for i in range(3):
        cli_run(lst, WORK / f"p{i}", "--backend", "dense")
    x_aug, coll = load_inputs(str(lst))
    stage_split(x_aug, coll.sx, "primary")
    print("dense scan under torch.profiler (primary):")
    profiled(lambda: md.ms_dense_heads_on_device(x_aug, coll.sx, "cuda"))
    del x_aug, coll

    lst = cs.write_workload(WORK / "ecoli", 42, 5_000_000, 20, 0.01)
    print("dense kernels alone (ecoli_dense):", flush=True)
    x_aug, coll = load_inputs(str(lst))
    cs.dense_kernel_case("ecoli_dense", x_aug, coll.sx)
    del x_aug, coll
    torch.cuda.empty_cache()
    dense_kernels(libs, lst, "ecoli_dense")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([str(cs.REF_BIN), "-r", "-o", str(WORK / "ref"),
                        str(lst)], capture_output=True, text=True,
                       timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"reference tool failed: {r.stderr[-2000:]}")
    print(f"ecoli reference tool -r: {time.perf_counter() - t0:.2f} s",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cli_run(lst, WORK / "e", "--backend", "dense", "-r")
    cli_peak = torch.cuda.max_memory_allocated()
    same = (WORK / "e.rl_bwt").read_bytes() == \
        (WORK / "ref.rl_bwt").read_bytes()
    print(f"ecoli -r bytes equal to the reference tool's: {same}")
    x_aug, coll = load_inputs(str(lst))
    m = md.joint_geometry(len(x_aug), coll.sx)[2]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = stage_split(x_aug, coll.sx, "ecoli")
    scan_peak = torch.cuda.max_memory_allocated()
    print(f"ecoli m={m} sn={coll.sn} h={res.h} rho={res.irreducible} "
          f"peak_bytes cli={cli_peak} scan={scan_peak} per_joint_char "
          f"cli={cli_peak / m:.1f} scan={scan_peak / m:.1f}", flush=True)
    if not same:
        raise RuntimeError("ecoli -r bytes differ from the reference tool")


def blocked_run(lst, out, *flags) -> bytes:
    """One blocked-route CLI run (cli_run) under chip_smoke.BlockLog: its
    block tries and peaks printed; returns the output's bytes. BlockLog
    resets the peak statistic per block, so cli_run's own peak_bytes
    counts from the last block's start; run_peak_bytes is the run's."""
    from cmsbwt_tpu_torch.ops import ms_dense as md
    torch.cuda.empty_cache()
    with cs.BlockLog(md) as bl:
        cli_run(lst, out, "--backend", "dense", *flags)
    print(f"blocks {' '.join(flags)}: tries={len(bl.tries)} "
          f"retries={bl.retries} run_peak_bytes={bl.run_peak} "
          f"peak_outside_blocks={bl.gap_peak} " + json.dumps(bl.tries),
          flush=True)
    ext = ".rl_bwt" if "-r" in flags else ".bwt"
    return out.with_suffix(ext).read_bytes()


def blocked_main() -> None:
    from cmsbwt_tpu_torch import kernels
    kernels.load()
    lst = cs.write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    cli_run(lst, WORK / "warm", "--backend", "dense")   # CUDA set-up
    big = cs.write_workload(WORK / "big", 42, 5_000_000, 100, 0.01)
    t0 = time.perf_counter()
    r = subprocess.run([str(cs.REF_BIN), "-r", "-o", str(WORK / "ref"),
                        str(big)], capture_output=True, text=True,
                       timeout=1800)
    if r.returncode != 0:
        raise RuntimeError(f"reference tool failed: {r.stderr[-2000:]}")
    print(f"500M reference tool -r: {time.perf_counter() - t0:.2f} s",
          flush=True)
    want = (WORK / "ref.rl_bwt").read_bytes()
    os.environ["CMSBWT_PROFILE"] = "1"
    print("500M, blocks chosen by the guard (stage marks on stderr):",
          flush=True)
    try:
        got = blocked_run(big, WORK / "g", "-r")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()
    same = {"guard": got == want}
    del got
    same["32Mi"] = blocked_run(big, WORK / "b", "-r", "--block-chars",
                               str(32 << 20)) == want
    print(f"500M -r bytes equal to the reference tool's: {same}",
          flush=True)
    if not all(same.values()):
        raise RuntimeError("500M -r bytes differ from the reference tool")
    shutil.rmtree(WORK / "big")
    eco = cs.write_workload(WORK / "ecoli", 42, 5_000_000, 20, 0.01)
    outs = [blocked_run(eco, WORK / f"e{i}", "-r",
                        *(["--block-chars", str(32 << 20)] if i in (1, 2)
                          else [])) for i in range(4)]
    print(f"ecoli_dense -r blocked bytes equal to unblocked: "
          f"{len(set(outs)) == 1}", flush=True)
    if len(set(outs)) != 1:
        raise RuntimeError("ecoli_dense blocked bytes differ")


def host_merge_main() -> None:
    """One CLI run above the device merge's memory ceiling: 5 Mbp x 200
    docs at 1% SNP (~1.0 Gchars), -r --no-rle-quirk, no --block-chars, so
    the guard chooses the blocks and merge_backend=auto the host merge.
    Prints the host's memory first (free -g), then the run's phases, its
    blocks, the peak device bytes and the host's peak RSS, and checks that
    the .rl_bwt decodes to sn chars with the collection's byte
    histogram."""
    import resource
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.device_merge import MERGE_BYTES_PER_CHAR
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_dense as md
    print(f"host: {cs.host_cpu(WORK)}", flush=True)
    print(subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60).stdout, flush=True)
    kernels.load()
    lst = cs.write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    cli_run(lst, WORK / "warm", "--backend", "dense")   # CUDA set-up
    t0 = time.perf_counter()
    big = cs.write_workload(WORK / "big", 42, 5_000_000, 200, 0.01)
    rss = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10
    print(f"1G: wrote 5 Mbp x 200 docs in {time.perf_counter() - t0:.1f} s; "
          f"host peak RSS so far {rss()} B; device free "
          f"{torch.cuda.mem_get_info()[0]} B (the device merge needs "
          f"{MERGE_BYTES_PER_CHAR} B per collection char)", flush=True)
    os.environ["CMSBWT_PROFILE"] = "1"
    print("1G, blocks chosen by the guard (stage marks on stderr):",
          flush=True)
    try:
        with cs.BlockLog(md) as bl:
            phases = cli_run(big, WORK / "h", "--backend", "dense", "-r",
                             "--no-rle-quirk")
    finally:
        del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()
    print(f"1G: blocks tries={len(bl.tries)} retries={bl.retries} "
          f"run_peak_bytes={bl.run_peak} peak_outside_blocks={bl.gap_peak} "
          f"host_peak_rss_bytes={rss()} " + json.dumps(bl.tries), flush=True)
    if "head_fixup" not in phases or "merge_device" in phases:
        raise RuntimeError("the 1G run did not take the host merge")
    _, coll = load_inputs(str(big))
    hist = cs.rle_histogram(WORK / "h.rl_bwt")
    same = int(hist.sum()) == coll.sn and np.array_equal(
        hist, np.bincount(coll.sx, minlength=256))
    print(f"1G: sn={coll.sn}; .rl_bwt decodes to {int(hist.sum())} chars "
          f"with the collection's byte histogram: {same}", flush=True)
    if not same:
        raise RuntimeError("the 1G .rl_bwt decodes to another histogram")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _part(summary: dict, name: str, fn) -> None:
    """One part of the mesh mode; a failure is printed, not raised."""
    try:
        summary[name] = fn()
    except Exception as e:       # the next part still runs
        import traceback
        traceback.print_exc()
        print(f"mesh[{name}]: FAILED {type(e).__name__}: {e}", flush=True)
        summary[name] = {"failed": f"{type(e).__name__}: {e}"}


def _histogram_ok(path: pathlib.Path, coll) -> bool:
    hist = cs.rle_histogram(path)
    return int(hist.sum()) == coll.sn and np.array_equal(
        hist, np.bincount(coll.sx, minlength=256))


def mesh_main() -> None:
    """The mesh routes over every visible card (see the module docstring,
    mesh mode)."""
    import resource
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.device_merge import download_runs, \
        merge_heads_device_resident
    from cmsbwt_tpu_torch.engine.pipeline import (load_inputs,
                                                  upload_heads_result)
    from cmsbwt_tpu_torch.ops import ms_dense as md
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    from cmsbwt_tpu_torch.parallel import distributed
    from cmsbwt_tpu_torch.parallel.mesh import ms_dense_heads_mesh
    from cmsbwt_tpu_torch.parallel.sharded_merge import merge_heads_sharded
    # a lost rank ends the part within 2 minutes (no collective of these
    # runs waits that long)
    os.environ.setdefault("CMSBWT_DIST_TIMEOUT", "120")
    cards = torch.cuda.device_count()
    rs = [r for r in (1, 2, 4) if r <= cards]
    kernels.load()
    summary = {"cards": cards, "names": [torch.cuda.get_device_name(i)
                                         for i in range(cards)]}
    fields = ("head_t", "head_pos", "head_len", "head_smaller", "head_char",
              "ref_sa", "ref_isa", "ref_bwt")
    lst = cs.write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    rss = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10

    def sharded(heads, coll, n, R, rq=False):
        out, s = _timed(lambda: merge_heads_sharded(
            *[getattr(heads, f) for f in fields], heads.h, n, coll.sn,
            coll.d, rq, n_devices=R, device="cuda"))
        return out, s, dict(distributed.LAST_RUN)

    def primary():
        x, coll = load_inputs(str(lst))
        jres = mj.ms_jump_heads(x, coll.sx, "cuda")
        dev = []
        for _ in range(3):
            want, s = _timed(lambda: download_runs(
                *merge_heads_device_resident(jres, coll.d, False)[:2]))
            dev.append(round(s, 4))
        print(f"mesh[primary]: h={jres.h} device merge s {dev}", flush=True)
        out = {"h": jres.h, "device_merge_s": dev}
        for R in rs:
            runs = []
            for _ in range(2):
                (rl, rc), s, last = sharded(jres, coll, len(x), R)
                if not (np.array_equal(rl, want[0])
                        and np.array_equal(rc, want[1])):
                    raise RuntimeError(f"R={R}: runs differ from the device "
                                       "merge's")
                runs.append(dict(wall_s=round(s, 4), **last))
                print(f"mesh[primary]: merge_sharded R={R} wall {s:.3f} s, "
                      "runs equal to the device merge's; "
                      + json.dumps(last), flush=True)
            out[f"sharded_R{R}"] = runs
        os.environ["CMSBWT_PROFILE"] = "1"
        print(f"mesh[primary]: stage marks at R={rs[-1]} (stderr)",
              flush=True)
        try:
            sharded(jres, coll, len(x), rs[-1])
        finally:
            del os.environ["CMSBWT_PROFILE"]
        sys.stderr.flush()
        return out

    def giant():
        normal = cli_run(lst, WORK / "normal", "--backend", "jump")
        os.environ["CMSBWT_GIANT_THRESHOLD"] = "1000"
        os.environ["CMSBWT_INDEX_CACHE"] = str(WORK / "cache")
        try:
            phases = cli_run(lst, WORK / "giant")
        finally:
            del os.environ["CMSBWT_GIANT_THRESHOLD"]
        last = dict(distributed.LAST_RUN)
        same = (WORK / "giant.bwt").read_bytes() == \
            (WORK / "normal.bwt").read_bytes()
        print(f"mesh[giant]: bytes equal to the jump CLI's: {same}; index "
              "build " + json.dumps(last), flush=True)
        if not same:
            raise RuntimeError("the giant route's bytes differ")
        return {"phases_ms": phases, "index_run": last,
                "jump_phases_ms": normal}

    def big():
        t0 = time.perf_counter()
        blst = cs.write_workload(WORK / "big", 42, 5_000_000, 100, 0.01)
        x, coll = load_inputs(str(blst))
        print(f"mesh[500M]: wrote and parsed in "
              f"{time.perf_counter() - t0:.1f} s; sn={coll.sn}", flush=True)
        R = rs[-1]
        guard = md.dense_block_chars(len(x), coll.sn, md.dense_budget("cuda"))
        block = max(min(-(-coll.sn // R), 1_000_000_000 // 8), 1 << 16)
        block = min(block, guard) if guard else block
        out = {"ranks": R, "block_chars": block, "one_card_s": [],
               "mesh_s": [], "mesh_runs": []}
        res = {}
        for turn in ("one_card", "mesh", "mesh", "one_card"):
            if turn == "mesh":
                r, s = _timed(lambda: ms_dense_heads_mesh(
                    x, coll.sx, block, device="cuda"))
                out["mesh_runs"].append(dict(distributed.LAST_RUN))
            else:
                r, s = _timed(lambda: md.ms_dense_heads_blocked_on_device(
                    x, coll.sx, "cuda", block, to_host=True))
            out[f"{turn}_s"].append(round(s, 3))
            res[turn] = r
            torch.cuda.empty_cache()
            print(f"mesh[500M]: {turn} scan, blocks of {block}: {s:.3f} s "
                  f"h={r.h} irreducible={r.irreducible}", flush=True)
        a, b = res["one_card"], res["mesh"]
        if a.h != b.h or any(not np.array_equal(getattr(a, f), getattr(b, f))
                             for f in fields):
            raise RuntimeError("the mesh scan's heads differ at 500M")
        del res, a
        out["merge_device_s"], out["merge_sharded_s"] = [], []
        out["merge_sharded_runs"] = []
        want = None
        for turn in ("device", "sharded", "sharded", "device"):
            if turn == "device":
                up = upload_heads_result(b, len(x), "cuda")
                got, s = _timed(lambda: download_runs(
                    *merge_heads_device_resident(up, coll.d, False,
                                                 want_counter=False)[:2]))
                del up
            else:
                got, s, last = sharded(b, coll, len(x), R)
                out["merge_sharded_runs"].append(last)
            torch.cuda.empty_cache()
            out[f"merge_{turn}_s"].append(round(s, 3))
            if want is None:
                want = got[:2]
            elif not (np.array_equal(got[0], want[0])
                      and np.array_equal(got[1], want[1])):
                raise RuntimeError("the 500M merges' runs differ")
            print(f"mesh[500M]: merge {turn} {s:.3f} s", flush=True)
        del b, want, got
        torch.cuda.empty_cache()
        out["cli_phases_ms"] = cli_run(
            blst, WORK / "b", "--backend", "dense", "--parallel",
            "--merge-backend", "sharded", "-r", "--no-rle-quirk")
        out["cli_histogram_ok"] = _histogram_ok(WORK / "b.rl_bwt", coll)
        print(f"mesh[500M]: CLI .rl_bwt histogram ok: "
              f"{out['cli_histogram_ok']}", flush=True)
        return out

    def gchar():
        if cards < 4:   # its sharded merge needs the memory of four cards
            print(f"mesh[1G]: skipped on {cards} card(s)", flush=True)
            return {"skipped": cards}
        t0 = time.perf_counter()
        glst = cs.write_workload(WORK / "g", 42, 5_000_000, 200, 0.01)
        print(f"mesh[1G]: wrote in {time.perf_counter() - t0:.1f} s",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        phases = cli_run(glst, WORK / "g", "--backend", "jump",
                         "--merge-backend", "sharded", "-r",
                         "--no-rle-quirk")
        last = dict(distributed.LAST_RUN)
        _, coll = load_inputs(str(glst))
        ok = _histogram_ok(WORK / "g.rl_bwt", coll)
        print(f"mesh[1G]: sn={coll.sn}; sharded merge " + json.dumps(last)
              + f"; rank 0 peak host RSS {rss()} B; histogram ok: {ok}",
              flush=True)
        return {"sn": coll.sn, "phases_ms": phases, "merge_run": last,
                "rank0_peak_rss_bytes": rss(), "histogram_ok": ok}

    for name, fn in (("primary", primary), ("giant", giant),
                     ("500M", big), ("1G", gchar)):
        _part(summary, name, fn)
        torch.cuda.empty_cache()
    print("mesh summary " + json.dumps(summary), flush=True)


def jump_main(cli_only: bool) -> None:
    lst = cs.write_workload(WORK, 42, 2_000_000, 10, 0.01)
    if not cli_only:
        kernel_sweep(lst)
    for lanes in (4096, 32768, 4096, 32768):
        cli_run(lst, WORK / f"t{lanes}", "--backend", "jump", "--lanes",
                str(lanes))
    if not cli_only:
        merge_profile(lst)


def merge_ab(parent: pathlib.Path, runs: int = 3) -> None:
    """The jump CLI at the primary shape, ``runs`` times in a fresh process
    per turn, in the older checkout ``parent`` and in this tree in turns
    (parent, this, this, parent): every run's merge_device and phases (the
    first run of a process also pays the card's set-up)."""
    lst = cs.write_workload(WORK / "ab", 42, 2_000_000, 10, 0.01)
    code = ("import sys\nfrom cmsbwt_tpu_torch import cli\n"
            "for o in sys.argv[2:]:\n"
            "    assert cli.main([sys.argv[1], '-o', o, '--device', "
            "'cuda', '--backend', 'jump']) == 0\n")
    for turn, (who, root) in enumerate((("parent", parent), ("this", ROOT),
                                        ("this", ROOT),
                                        ("parent", parent))):
        outs = [WORK / f"ab{turn}_{i}" for i in range(runs)]
        subprocess.run([sys.executable, "-c", code, str(lst),
                        *map(str, outs)], cwd=root.resolve(), check=True,
                       timeout=900)
        for i, out in enumerate(outs):
            ph = cs.phases_from_log(out.with_suffix(".log"))
            print(f"merge A/B turn {turn} {who} run {i}: merge_device_ms="
                  f"{ph['merge_device']} phases_ms {json.dumps(ph)}",
                  flush=True)


def kernel_sweep(lst) -> None:
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index.device import build_device_index
    from cmsbwt_tpu_torch.ops import ms_jump as mj

    x_aug, coll = load_inputs(str(lst))
    kernels.load()
    ix = build_device_index(x_aug, "cuda")
    n, sn = ix.n, coll.sn
    trees = mj.build_block_trees(ix.lcp, ix.plcp, n)
    for lanes in SWEEP:
        split = mj.split_lanes(coll.sx, lanes, 64, "cuda")
        states = iter([split.init_state(n) for _ in range(6)])
        last = {}

        def launch():
            last["st"] = kernels.ms_jump_scan_cuda(
                ix.x_padded, ix.sa, ix.isa, trees, split.sx_padded,
                next(states), split.ends_dev, n=n, sn=sn, cap=split.cap,
                window=64)
        launch()
        ms = cs.cuda_ms(launch, 5)
        print(f"kernel lanes={lanes} cap={split.cap} ms={ms:.3f} "
              f"viol={bool(last['st']['viol'].any())}", flush=True)


def merge_profile(lst) -> None:
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_jump as mj

    x_aug, coll = load_inputs(str(lst))
    res = mj.ms_jump_heads(x_aug, coll.sx, "cuda", lanes=32768)
    os.environ["CMSBWT_PROFILE"] = "1"
    print("merge stages (stderr, lanes=32768):", flush=True)
    dm.merge_heads_device_resident(res, coll.d, False, want_counter=False)
    del os.environ["CMSBWT_PROFILE"]
    sys.stderr.flush()
    print("merge under torch.profiler:")
    profiled(lambda: dm.merge_heads_device_resident(res, coll.d, False,
                                                    want_counter=False))


MERGE_SHAPES = (("primary", 42, 2_000_000, 10, 0.01),
                ("500M", 42, 5_000_000, cs.BIG_DOCS, 0.01))


def bucket_sums_case(name: str, args: tuple) -> None:
    """runs_emit_dev's three accumulating sums (hb_at and ncls_at over
    n_pad, hb_b over h_pad) on the lanes one merge gave it (``args``: its
    arguments): each timed alone as the merge's plain version runs it
    (``_add``: a masked ``index_put_`` with accumulate), the same sum with
    the pad lanes left out, and as ``Tensor.index_add_`` on the same
    indices and values; then the bucket_sums kernel where the port has
    one. Prints h_pad, nec and the lanes the sums send to index 0."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    cls, sa_ord, ref_isa = args[0], args[1], args[7]
    h_pad, n_pad = args[11], args[12]
    nec, evalid, _, m_c, br, _, bid = dm.bucket_lanes(cls, sa_ord, ref_isa,
                                                       h_pad, n_pad)
    br0 = dm._w32(evalid, br, 0)
    every = torch.ones_like(evalid)
    bidc = torch.clamp(bid, 0, h_pad - 1)
    to_zero = int((br0 == 0).sum())
    print(f"bucket_sums[{name}]: h_pad={h_pad} n_pad={n_pad} nec={nec} "
          f"lanes to index 0: {to_zero} (pad lanes {h_pad - max(nec, 0)}, "
          f"valid lanes of rank 0 {to_zero - (h_pad - max(nec, 0))}); "
          f"buckets {int(bid[max(nec, 1) - 1]) + 1 if nec > 0 else 0}",
          flush=True)

    def zero(k):
        return torch.zeros(k, dtype=torch.int32, device=br.device)
    sums = {"hb_at": (n_pad, br0, m_c, every),
            "ncls_at": (n_pad, br0, torch.ones_like(br0), every),
            "hb_b": (h_pad, bidc, m_c, evalid)}
    total = {"put": 0.0, "lib": 0.0}
    for k, (size, idx, val, mask) in sums.items():
        want = dm._add(zero(size), idx, val, mask)
        put = cs.cuda_ms(lambda: dm._add(zero(size), idx, val, mask), 2)
        no_pad = cs.cuda_ms(lambda: dm._add(zero(size), idx, val, evalid), 2)
        il, vl = idx[mask].long(), val[mask]
        got = zero(size).index_add_(0, il, vl)
        if not torch.equal(got, want):
            raise SystemExit(f"bucket_sums[{name}]: index_add_ differs on "
                             f"{k}")
        lib = cs.cuda_ms(lambda: zero(size).index_add_(0, il, vl), 2)
        total["put"] += put
        total["lib"] += lib
        print(f"bucket_sums[{name}]: {k}: index_put_ accumulate "
              f"(the merge's _add) {put:.3f} ms; without the pad lanes "
              f"{no_pad:.3f} ms; index_add_ {lib:.3f} ms", flush=True)
    print(f"bucket_sums[{name}]: the three sums: index_put_ "
          f"{total['put']:.3f} ms, index_add_ {total['lib']:.3f} ms",
          flush=True)
    if hasattr(kernels, "bucket_sums_cuda"):
        outs = kernels.bucket_sums_cuda(br, bid, m_c, nec, n_pad)
        dm.bucket_sums_check(outs[3])
        for k, got in zip(sums, outs[:3]):
            size, idx, val, mask = sums[k]
            if not torch.equal(got, dm._add(zero(size), idx, val, mask)):
                raise SystemExit(f"bucket_sums[{name}]: the kernel differs "
                                 f"on {k}")
        ms = cs.cuda_ms(lambda: kernels.bucket_sums_cuda(br, bid, m_c, nec,
                                                         n_pad), 5)
        print(f"bucket_sums[{name}]: the kernel (zeroed outputs included) "
              f"{ms:.3f} ms", flush=True)


# merge_device's stages, in call order (engine/device_merge.py)
MERGE_STAGES = ("fixup_dev", "tail_counts_dev", "group_dev",
                "class_ranks_dev", "head_string_sa_dev", "rank_heads_dev",
                "tail_pairs_count_dev", "tail_good_dev", "tail_exact_dev",
                "runs_emit_dev")
MERGE_RUNS = 3      # timed merges a turn, after one to warm up
CLI_RUNS = 3        # jump -r CLI runs a turn


def merge_stages_main(only: str | None, parent: pathlib.Path | None) -> None:
    """The device merge of the jump scan's heads at each shape of
    MERGE_SHAPES, measured in a child process per turn that imports the
    package from one checkout (merge_child): this tree alone, or with
    ``parent`` (an older checkout's root) parent, this, this, parent.
    Ends with a ``merge_stages summary {json}`` line: per shape and tree
    every timed run's merge_device, head_string_sa and tail_good ms, peak
    bytes per collection char, and the jump -r CLI's seconds and
    merge_device phase."""
    shapes = []
    for name, seed, ref_len, docs, snp in MERGE_SHAPES:
        if only and name not in only.split(","):
            continue
        t0 = time.perf_counter()
        lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
        print(f"wrote {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        shapes.append((name, str(lst)))
    turns = [("this", ROOT)] if parent is None else [
        ("parent", parent.resolve()), ("this", ROOT), ("this", ROOT),
        ("parent", parent.resolve())]
    summary = {}
    for tag, root in turns:
        spec = json.dumps({"root": str(root), "shapes": shapes, "tag": tag,
                           "full": parent is None})
        for line in _turn_child(tag, ["--merge-child", spec]):
            for key in ("merge_run", "cli_run"):
                if line.startswith(key + " {"):
                    d = json.loads(line[len(key) + 1:])
                    summary.setdefault(d.pop("shape"), {}).setdefault(
                        d.pop("tag"), {}).setdefault(key, []).append(d)
    print("merge_stages summary " + json.dumps(summary), flush=True)


def _turn_child(tag: str, args: list, timeout: int = 1500) -> list:
    """One turn's child process (this script with ``args``), its native
    runtimes built into the turn's tree's own directory; echoes its
    output and returns its stdout lines."""
    t0 = time.perf_counter()
    env = dict(os.environ, CMSBWT_NATIVE_DIR=str(WORK / f"native_{tag}"))
    r = subprocess.run([sys.executable, __file__, *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    sys.stdout.write(r.stdout)
    sys.stderr.write(r.stderr[-6000:])
    if r.returncode:
        raise SystemExit(f"the {tag} child failed ({r.returncode})")
    print(f"turn {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return r.stdout.splitlines()


def output_main(only: str | None, parent: pathlib.Path | None,
                step0: bool, runs: int) -> None:
    """The output mode (see the module's docstring)."""
    gpu = card()
    shapes = []
    for name, seed, ref_len, docs, snp in MERGE_SHAPES:
        if only and name not in only.split(","):
            continue
        t0 = time.perf_counter()
        lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
        print(f"wrote {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        shapes.append((name, str(lst)))
    print(f"host: {cs.host_cpu(WORK)}", flush=True)
    roots = {"this": ROOT, "parent": parent.resolve() if parent else None}
    if step0:
        tag = "parent" if parent else "this"
        _turn_child(tag, ["--output-child", json.dumps({
            "step0": True, "root": str(roots[tag]), "shapes": shapes,
            "tag": tag, "card": gpu, "runs": 1})])
    turns = ["this"] if parent is None else [
        "parent", "this", "this", "parent"]
    summary, digests = {}, {}
    for tag in turns:
        for line in _turn_child(tag, ["--output-child", json.dumps({
                "step0": False, "root": str(roots[tag]), "shapes": shapes,
                "tag": tag, "card": gpu, "runs": runs})]):
            if not line.startswith("cli_run {"):
                continue
            d = json.loads(line.split(" ", 1)[1])
            digests.setdefault((d["shape"], d["format"]), set()).add(
                d["sha1"])
            ph = d["phases_ms"]
            summary.setdefault(f"{d['shape']} {d['format']}", {}).setdefault(
                tag, []).append({"wall_s": d["wall_s"],
                                 "merge_device_ms": ph.get("merge_device"),
                                 "write_output_ms": ph.get("write_output")})
    same = all(len(v) == 1 for v in digests.values())
    print("output_ab summary " + json.dumps(
        {"card": gpu, "same_bytes": same, "runs": summary}), flush=True)
    if not same:
        raise SystemExit("the trees wrote different bytes")


def _sync_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def output_child(spec: dict) -> None:
    """One turn of output_main: the package imported from spec["root"];
    step 0 per shape when spec["step0"], then the CLI runs."""
    sys.path.insert(0, spec["root"])
    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    print(f"child {spec['tag']}: package "
          f"{pathlib.Path(dm.__file__).parents[1]}", flush=True)
    kernels.load()
    for name, lst in spec["shapes"]:
        if spec["step0"]:
            output_step0(dm, name, lst, spec["card"])
            formats = [("-r", "--no-rle-quirk")]
        else:
            formats = [("-r", "--no-rle-quirk")] + (
                [()] if name == "primary" else [])
        for flags in formats:
            for i in range(spec["runs"]):
                out = WORK / f"cli_{name}_{spec['tag']}_{i}"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if cli.main([lst, "-o", str(out), "--device", "cuda",
                             "--backend", "jump", *flags]):
                    raise SystemExit("cli failed")
                wall = time.perf_counter() - t0
                data = out.with_suffix(".rl_bwt" if flags else ".bwt")
                print("cli_run " + json.dumps({
                    "shape": name, "tag": spec["tag"], "run": i,
                    "card": spec["card"], "format": data.suffix[1:],
                    "wall_s": wall, "bytes": data.stat().st_size,
                    "sha1": hashlib.sha1(data.read_bytes()).hexdigest(),
                    "phases_ms": cs.phases_from_log(
                        out.with_suffix(".log"))}), flush=True)
                for f in WORK.glob(out.name + ".*"):
                    f.unlink()


def output_step0(dm, name: str, lst: str, gpu: str) -> None:
    """Step 0 of the output mode at one shape (see the module's
    docstring): one ``step0 {json}`` line."""
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.io import fasta, native
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    ref_path, coll_path = fasta.read_input_list(lst)
    limit = fasta.collection_sn_limit(coll_path, 1 << 64)
    t0 = time.perf_counter()
    sx, _ = native.parse_collection_native(coll_path, limit)
    t1 = time.perf_counter()
    seps = np.nonzero(sx == fasta.SEPARATOR)[0].astype(np.int64)
    t2 = time.perf_counter()
    bad = (sx < fasta.ALPHABET_AUGMENT_LO) | (sx >= fasta.ALPHABET_AUGMENT_HI)
    bad &= sx != fasta.SEPARATOR
    if np.any(bad):
        raise SystemExit(f"{name}: a collection byte outside [3, 128)")
    t3 = time.perf_counter()
    parse = {"native_read_copy_s": t1 - t0, "nonzero_s": t2 - t1,
             "validate_masks_s": t3 - t2, "seps": len(seps)}
    del sx, seps, bad
    x_aug, coll = load_inputs(lst)
    res, heads_s = _sync_s(lambda: mj.ms_jump_heads(x_aug, coll.sx, "cuda"))
    sn, d = coll.sn, coll.d
    del coll
    torch.cuda.empty_cache()
    merge = lambda: dm.merge_heads_device_resident(res, d, False,
                                                   want_counter=False)
    merge()
    kept = {}

    def keep(*a):
        kept["out"] = orig(*a)
        return kept["out"]
    orig = dm.run_merge
    dm.run_merge = keep
    try:
        _, merge_s = _sync_s(merge)
    finally:
        dm.run_merge = orig
    rl_d, rc_d, R = kept["out"]
    rl, dl_len_s = _sync_s(lambda: rl_d.cpu().numpy().astype(np.int64))
    rc, dl_chr_s = _sync_s(lambda: rc_d.cpu().numpy())
    path = WORK / f"step0_{name}.rl_bwt"
    t0 = time.perf_counter()
    if not native.write_rle_native(str(path), rl, rc):
        raise SystemExit("the native RLE writer could not be built")
    writer_s = time.perf_counter() - t0
    size = path.stat().st_size
    path.unlink()
    writes = {}
    for what, nb in (("rl_bwt", size), ("bwt", sn)):
        pinned = torch.empty(nb, dtype=torch.uint8, pin_memory=True)
        pinned.fill_(65)
        view = memoryview(pinned.numpy())
        t0 = time.perf_counter()
        with open(WORK / f"write_{what}", "wb") as f:
            f.write(view)
        writes[f"f_write_{what}_s"] = time.perf_counter() - t0
        (WORK / f"write_{what}").unlink()
        del pinned, view
    print("step0 " + json.dumps({
        "shape": name, "card": gpu, "sn": sn, "h": res.h, "R": R,
        "rl_bwt_bytes": size, "parse": parse, "jump_heads_s": heads_s,
        "merge_device_s": merge_s, "download_run_len_s": dl_len_s,
        "download_run_char_s": dl_chr_s, "host_rle_writer_s": writer_s,
        **writes}), flush=True)
    del res, rl_d, rc_d, kept, rl, rc
    torch.cuda.empty_cache()


def _synced(fn, sink: list):
    """``fn`` with the device synchronised at its entry and exit, its wall
    ms appended to ``sink``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


class _Patched:
    """Set attributes of modules for the length of a with block."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(m, k, getattr(m, k)) for m, k, _ in self.triples]
        for m, k, v in self.triples:
            setattr(m, k, v)
        return self

    def __exit__(self, *exc):
        for m, k, v in self.saved:
            setattr(m, k, v)


def _host_reads(counts: dict) -> _Patched:
    """Count the reads of a CUDA tensor's values by the host (each a
    synchronisation) into counts["n"]."""
    def counted(f):
        def read(self, *a, **kw):
            if self.is_cuda:
                counts["n"] += 1
            return f(self, *a, **kw)
        return read
    return _Patched(*[(torch.Tensor, k, counted(getattr(torch.Tensor, k)))
                      for k in ("__int__", "__bool__", "__float__", "item",
                                "tolist", "cpu")])


def _unresolved(rank) -> int:
    """Rows of ``rank`` whose value another row shares (groups of two or
    more)."""
    counts = torch.bincount(rank.long())
    return int(counts[counts > 1].sum())


def head_string_split(dm, idx, merge) -> dict:
    """One merge with head_string_sa taken apart by call (a call ends at
    its one host read, ``_read_round``, or an older checkout's
    ``_read_top`` or ``_largest``; the tail's call runs several rounds):
    its sort if it has one (rows sorted, device-synced ms) and its rank
    step (the sort's end, or the read before, to the end of the call's
    read), the wrapper's host time of a compacted call (``comp_rank``,
    ``comp_tail``, unsynced: the launch's host cost) and the read's own ms
    (the wait for the card and the copy), the rows the call took and left
    unresolved (the read's count, or for an older checkout counted from
    the round's ranks after the merge) and the rounds it ran, the rounds,
    k_star, the host's reads of device values and the rest (the
    compaction of the real suffixes, the shifted keys, the glue)."""
    marks, whole, sa_out, ranks = [], [], [], []
    reads = {"n": 0}
    sad, hs, sort0 = (idx.suffix_array_device, dm.head_string_sa_dev,
                      idx.stable_argsort)
    read_name = next(k for k in ("_read_round", "_read_top", "_largest")
                     if hasattr(idx, k))
    read0 = getattr(idx, read_name)
    rank0 = idx.dense_rank
    comps = [k for k in ("comp_rank", "comp_tail") if hasattr(idx, k)]

    def now():
        torch.cuda.synchronize()
        return time.perf_counter()

    def sort(keys, bits, values=False):
        t0 = now()
        out = sort0(keys, bits, values)
        marks.append(("sort", t0, now(), int(keys[0].shape[0])))
        return out

    def read(top):
        t0 = time.perf_counter()
        got = read0(top)
        t1 = time.perf_counter()
        marks.append(("read", now(), got, (t1 - t0) * 1e3))
        return got

    def rank(*a, **kw):
        out = rank0(*a, **kw)
        if read_name == "_largest":    # the older form reads no count
            ranks.append(out[0])
        return out

    def timed(fn):
        def comp(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            marks.append(("comp", (time.perf_counter() - t0) * 1e3))
            return out
        return comp

    def sa_dev(*a, **kw):
        t0 = now()
        out = sad(*a, **kw)
        sa_out.append((a[1], out[3], out[2] is not None, t0))
        return out

    def counted(*a, **kw):
        with _host_reads(reads):
            return hs(*a, **kw)
    patched = [(idx, "stable_argsort", sort), (idx, read_name, read),
               (idx, "dense_rank", rank),
               (idx, "suffix_array_device", sa_dev),
               (dm, "head_string_sa_dev", _synced(counted, whole))]
    patched += [(idx, k, timed(getattr(idx, k))) for k in comps]
    with _Patched(*patched):
        merge()
    L, k_star, hist, start = sa_out[0]
    # a round ends at its read; the sorts after the last read are the
    # real suffixes' compaction's
    rounds, cur, t_prev, rows = [], [], start, L
    for m in marks:
        if m[0] != "read":
            cur.append(m)
            continue
        sorts = [c for c in cur if c[0] == "sort"]
        host = [c[1] for c in cur if c[0] == "comp"]
        step0 = sorts[-1][2] if sorts else t_prev
        word, run = (m[2][0], m[2][2]) if isinstance(m[2], (tuple, list)) \
            else (m[2], 1)
        rounds.append({
            "rows": rows, "rounds": run,
            "rows_sorted": sum(c[3] for c in sorts),
            "sort_ms": sum((c[2] - c[1]) * 1e3 for c in sorts),
            "rank_step_ms": (m[1] - step0) * 1e3,
            "wrapper_host_ms": sum(host) if host else None,
            "read_ms": m[3], "read": word})
        rows = word
        cur, t_prev = [], m[1]
    if read_name == "_largest":
        for r, rk in zip(rounds, ranks):
            r["unresolved"] = _unresolved(rk)
    else:
        for r in rounds:
            r["unresolved"] = r["read"]
    sorts = sum(r["sort_ms"] for r in rounds)
    steps = sum(r["rank_step_ms"] for r in rounds)
    levels = idx.n_levels(L)
    return {"L": L, "levels": levels, "k_star": int(k_star),
            "rounds": sum(r["rounds"] for r in rounds), "calls": len(rounds),
            "history": hist,
            "history_bytes": 4 * levels * L if hist else 0,
            "wall_ms": whole[0], "sorts_ms": sorts, "rank_steps_ms": steps,
            "rest_ms": whole[0] - sorts - steps,
            "rows_sorted": sum(r["rows_sorted"] for r in rounds),
            "host_reads": reads["n"], "per_round": rounds}


# text edits of sa_round.cu (each text must occur once) that take a part
# of the rank steps out, for timing only (their outputs are wrong):
# key 1 read in sorted-row order instead of through the order (the full
# step's cost less its key-1 gather); the compacted round's rank stores,
# its suffix-array stores, its next-slice stores, its look-back (each
# tile its own prefix) and its counting sort (every row kept in place);
# the full group-start step's slice stores; the compacted round's sort
# by counting only or by the bitonic network only
RANK_VARIANTS = {
    "key1_in_order": (("__ldcs(a.key1 + src[j])", "__ldcs(a.key1 + r0 + j)"),),
    "comp_no_rank": (("    if ((o >> 30 & 1u) && unsigned(tq) < unsigned(a.m)) "
                      "a.rank[tq] = s_k1[q];\n", ""),),
    "comp_no_sa": (("    if (!(o >> 31) && (o & NO_PLACE) != NO_PLACE) "
                    "a.sa[o & NO_PLACE] = tq;\n", ""),),
    "comp_no_slice": (("    if ((o >> 31) && d < a.cap) {\n"
                       "      a.ti_n[d] = s_ts[q];\n"
                       "      a.k0_n[d] = s_k1[q];\n    }", ""),),
    "comp_no_lookback": (("lookback<CountFaultOp>(a.slots, t, agg)",
                          "CountFault{0, 0}"),),
    "comp_no_count": (("        for (int j = g0; j < g1; ++j) {\n"
                       "          const int kj = s_k1[j];\n"
                       "          c += kj < k || (kj == k && j < i);\n"
                       "        }", "        c = i - g0;"),),
    # sort_groups by counting whatever a block's largest group, or by its
    # bitonic network whatever (--comp-groups)
    "groups_count": (("constexpr int C_SMALL = ",
                      "constexpr int C_SMALL = (1 << 30) + 0 * "),),
    "groups_bitonic": (("constexpr int C_SMALL = ",
                        "constexpr int C_SMALL = 0 * "),),
    "start_no_slice": (("          a.ti_n[run.cnt] = src[j];\n"
                        "          a.k0_n[run.cnt] = rk[j];", "          ;"),),
}


def _kernel_device_ms(fn) -> dict:
    """Device ms of each kernel of one call of ``fn`` (torch.profiler),
    after one call to warm it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key[:48]: round(e.self_device_time_total / 1e3, 4)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


_VARIANT_LIBS: dict = {}


def rank_variant_libs(K, root: pathlib.Path) -> dict:
    """Each RANK_VARIANTS edit of the checkout's sa_round.cu that fits,
    built at once by parallel nvcc processes with the port's flags and
    bound with the committed library's signatures: {name: library}."""
    import ctypes
    if _VARIANT_LIBS:
        return _VARIANT_LIBS
    text = (root / "cmsbwt_tpu_torch/kernels/csrc/sa_round.cu").read_text()
    d = WORK / "rank_variants"
    d.mkdir(parents=True, exist_ok=True)
    csrc = root / "cmsbwt_tpu_torch/kernels/csrc"
    jobs = {}
    for name, edits in RANK_VARIANTS.items():
        if not all(text.count(old) == 1 for old, _ in edits):
            print(f"rank variant {name}: its edit does not fit", flush=True)
            continue
        src = text
        for old, new in edits:
            src = src.replace(old, new)
        (d / f"{name}.cu").write_text(src)
        jobs[name] = subprocess.Popen(
            [K._nvcc(), *K.NVCC_FLAGS, f"-I{csrc}", "-o",
             str(d / f"lib{name}.so"), str(d / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    committed = K.load()["sa_round"]
    for name, proc in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on rank variant {name}:\n{out}")
        lib = ctypes.CDLL(str(d / f"lib{name}.so"))
        for fname, f in vars(committed).items():
            if isinstance(f, ctypes._CFuncPtr):
                g = getattr(lib, fname)
                g.restype, g.argtypes = f.restype, f.argtypes
        _VARIANT_LIBS[name] = lib
    return _VARIANT_LIBS


def _with_lib(K, lib, call) -> dict:
    """``call`` timed (5 calls between CUDA events) and by kernel with
    sa_round's library swapped for ``lib``."""
    saved = K.load()["sa_round"]
    K.load()["sa_round"] = lib
    try:
        call()
        return {"ms": cs.cuda_ms(call, 5), "kernels_ms": _kernel_device_ms(call)}
    finally:
        K.load()["sa_round"] = saved


def _rank_launch(K, args, kw):
    """dense_rank's C entry point on one step with its outputs made
    beforehand (chip_smoke.dense_rank_launch; for an older checkout,
    whose C call took only the order, the keys, the rank and the
    stagings, that call): (launch(scratch), scratch bytes)."""
    if hasattr(K, "RankWork"):
        return cs.dense_rank_launch(K, args, kw)
    from cmsbwt_tpu_torch.ops.sort import fault_word
    lib = K.load()["sa_round"]
    order, s0, key1 = args[:3]
    n = order.numel()
    shift = K.sa_round_bins(n).shift
    m4 = (n + 3) & ~3
    rank = torch.empty(n, dtype=torch.int32, device="cuda")
    st, st2 = (torch.empty(2 * m4, dtype=torch.int32, device="cuda")
               for _ in range(2))
    p = lambda t: None if t is None else cs._p(t)

    def launch(scratch):
        if lib.dense_rank_launch(p(order), p(s0), p(key1), p(rank), p(st),
                                 p(st2), n, shift, p(scratch),
                                 p(fault_word(order.device)), cs._stream()):
            raise SystemExit("dense_rank launch failed")
    return launch, int(lib.sa_round_scratch_bytes(n, n, shift))


def dense_rank_split(K, idx, args, kw, root: pathlib.Path,
                     variants: bool = True) -> dict:
    """One full rank step of the head string (``idx.dense_rank``'s
    arguments from a merge, cloned) taken apart: as the dispatch runs it
    (5 calls between CUDA events), each of its kernels' device ms
    (torch.profiler), and the same with key 1 read in sorted-row order
    (RANK_VARIANTS: the rest of the step; its difference the gather) and
    without its slice's stores."""
    call = lambda: idx.dense_rank(*args, **kw)
    out = {"rows": int(args[0].numel()), "ms": cs.cuda_ms(call, 5),
           "kernels_ms": _kernel_device_ms(call)}
    for name, lib in (rank_variant_libs(K, root).items() if variants
                      else ()):
        if name in ("key1_in_order", "start_no_slice"):
            out[name] = _with_lib(K, lib, call)
    out["alone_ms"] = cs.alone_ms(*_rank_launch(K, args, kw))
    out["copy_16B_ms"] = cs.copy_ms(16 * out["rows"])
    print("dense_rank_split " + json.dumps(out), flush=True)
    return out


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    return tuple(map(_clone, v)) if isinstance(v, tuple) else v


def capture_rank_step(idx, merge):
    """The first two-key full rank step of one merge's head string, the
    step the main path runs (this tree: the first round, on the pairs,
    with its slice and the slice's key 1; a checkout with a one-key seed:
    round 0, after it): ``idx.dense_rank``'s positional and keyword
    arguments, tensors cloned (later rounds reuse their buffers; each
    call then makes its own scratch)."""
    got, rank0 = [], idx.dense_rank

    def rank(*a, **kw):
        if not got and len(a) > 2 and a[2] is not None:
            got.append(([_clone(v) for v in a],
                        {k: _clone(v) for k, v in kw.items()
                         if k != "work"}))
        return rank0(*a, **kw)
    with _Patched((idx, "dense_rank", rank)):
        merge()
    return got[0]


GROUP_EDGES = (256, 1024, 2048, 4096, 8192)


def group_stats(k0) -> dict:
    """The groups of a compacted round's slice (runs of equal key 0 in
    sorted order, ``k0``): their count, the largest, the row-weighted
    mean size (sum of squares over rows) and the rows in groups larger
    than each of GROUP_EDGES."""
    _, size = torch.unique_consecutive(k0, return_counts=True)
    size = size.long()
    return {"groups": int(size.numel()), "largest": int(size.max()),
            "row_weighted_mean": float((size * size).sum() / size.sum()),
            **{f"rows_in_groups_gt_{e}": int(size[size > e].sum())
               for e in GROUP_EDGES}}


def comp_split(K, idx, merge, root: pathlib.Path) -> None:
    """The head string's first full step and its compacted calls (every
    round after the first, and the tail), each as the dispatch runs it (5
    calls between CUDA events, on copies of its inputs), alone
    (chip_smoke.dense_rank_comp_launch) and by kernel (torch.profiler),
    with its slice's groups (group_stats), the first compacted round also
    with each compacted-round edit of RANK_VARIANTS: ``first_split`` and
    ``comp_split`` lines."""
    if not hasattr(idx, "comp_tail"):
        return
    got, first = [], []
    comp0, tail0, rank0 = idx.comp_rank, idx.comp_tail, idx.dense_rank

    def comp(slice_, u, large, rank, sa, nxt_slice, shift, work=None):
        got.append(cs.comp_clone(slice_, u, large, rank, sa, nxt_slice,
                                 shift, 0))
        return comp0(slice_, u, large, rank, sa, nxt_slice, shift, work)

    def tail(slice_, u, rank, sa, nxt_slice, shift, rounds, work=None):
        got.append(cs.comp_clone(slice_, u, 0, rank, sa, nxt_slice, shift,
                                 rounds))
        return tail0(slice_, u, rank, sa, nxt_slice, shift, rounds, work)

    def rank(*a, **kw):
        if not first:
            first.append(([_clone(v) for v in a],
                         {k: _clone(v) for k, v in kw.items()
                          if k != "work"}))
        return rank0(*a, **kw)
    with _Patched((idx, "comp_rank", comp), (idx, "comp_tail", tail),
                  (idx, "dense_rank", rank)):
        merge()
    a, kw = first[0]
    call = lambda: idx.dense_rank(*a, **kw)
    out = {"rows": int(a[0].numel()), "ms": cs.cuda_ms(call, 5),
           "kernels_ms": _kernel_device_ms(call)}
    lib = rank_variant_libs(K, root).get("start_no_slice")
    if lib is not None:
        out["start_no_slice"] = _with_lib(K, lib, call)
    print("first_split " + json.dumps(out), flush=True)
    for i, args in enumerate(got):
        sl, u, large, rk, sa, ns, shift, rounds = args
        if rounds:
            call = lambda: idx.comp_tail(_clone(sl), u, rk.clone(),
                                         sa.clone(), _clone(ns), shift,
                                         rounds)
        else:
            call = lambda: idx.comp_rank(_clone(sl), u, large, rk.clone(),
                                         sa.clone(), _clone(ns), shift)
        out = {"step": i, "rows": u, "large": large, "tail_rounds": rounds,
               "m": int(rk.numel()), "ms": cs.cuda_ms(call, 5),
               "alone_ms": (cs.alone_ms(*cs.dense_rank_comp_launch(K, args,
                                                                  5))
                            if not large else None),
               "kernels_ms": _kernel_device_ms(call),
               "copy_bound_ms": cs.copy_ms(cs.comp_step_bytes(
                   args, cs.comp_step_run(cs._kernel_and_plain(K, idx)[3],
                                          args))),
               **group_stats(sl[1])}
        if i == 0:
            for name, lib in rank_variant_libs(K, root).items():
                if name.startswith("comp_"):
                    out[name] = _with_lib(K, lib, call)
        print("comp_split " + json.dumps(out), flush=True)


# made slices of the 500 Mchar merge's first compacted round (9 602 118
# of 36 051 597 rows: PERF.md §5) in groups of each size
COMP_GROUP_SIZES = (2, 4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 1024, 4096,
                    8192)
COMP_GROUP_ROWS, COMP_GROUP_M = 9_602_118, 36_051_597


def comp_groups_main(root: pathlib.Path) -> None:
    """dense_rank_comp's round on made slices of COMP_GROUP_ROWS rows of m
    = COMP_GROUP_M in groups of each of COMP_GROUP_SIZES rows (key 0 the
    group's start, key 1 drawn from 1 .. g / 2 + 1 for groups of g rows,
    so ties stay; distinct text positions; seeded): this tree's kernel,
    and sort_groups by counting only and by the bitonic network only
    (RANK_VARIANTS), each held to the plain round (exact, every output)
    and timed alone (chip_smoke.dense_rank_comp_launch) and with its
    wrapper (chip_smoke.comp_wrapper_ms; groups above the cap take the
    large path, pick, radix_sort and comp_large_kernel first); beside it
    radix_sort of the whole slice by (key 0, key 1), what the large path
    sorts for each of its rows: ``comp_groups`` lines."""
    from cmsbwt_tpu_torch import kernels as K
    from cmsbwt_tpu_torch.index import device as idx
    from cmsbwt_tpu_torch.ops.sort import fault_word
    libs = {"this": K.load()["sa_round"]}
    libs.update((name, lib) for name, lib in
                rank_variant_libs(K, root).items()
                if name.startswith("groups_"))
    _, _, kern, plain = cs._kernel_and_plain(K, idx)
    u, m = COMP_GROUP_ROWS, COMP_GROUP_M
    fault = fault_word("cuda:0")
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    fill = lambda k: torch.full((k,), -7, dtype=torch.int32, device="cuda")
    for g in COMP_GROUP_SIZES:
        rng = np.random.default_rng(g)
        sizes = np.full(u // g, g, np.int64)
        if u % g:
            sizes = np.r_[sizes, u % g]
        k0 = np.repeat(np.cumsum(np.r_[0, sizes[:-1]]), sizes)
        k1 = rng.integers(1, g // 2 + 2, u)
        ti = rng.permutation(m)[:u]
        rank = rng.integers(0, m, m)
        rank[ti] = k0
        large = int(sizes[sizes > K.COMP_CAP].sum())
        args = ((dev(ti), dev(k0), dev(k1)), u, large, dev(rank), fill(m),
                (fill(u), fill(u)), 16, 0)
        want = cs.comp_step_run(plain, args)
        out = {"group_rows": g, "rows": u, "m": m, "large": large,
               "unresolved": int(want[0][0])}
        saved = K.load()["sa_round"]
        try:
            for name, lib in libs.items():
                K.load()["sa_round"] = lib
                got = cs.comp_step_run(kern, args)
                if not all(a.shape == b.shape and torch.equal(a, b)
                           for a, b in zip(want, got)):
                    raise SystemExit(f"comp_groups: {name} differs from the "
                                     f"plain round at groups of {g}")
                out[name] = {"wrapper_ms": cs.comp_wrapper_ms(K, args)}
                if not large:
                    out[name]["alone_ms"] = cs.alone_ms(
                        *cs.dense_rank_comp_launch(K, args, 5))
        finally:
            K.load()["sa_round"] = saved
        keys = (args[0][1], args[0][2])
        out["radix_sort_ms"] = cs.library_ms(
            lambda: K.radix_sort_cuda(keys, (m.bit_length(),
                                             (m + 1).bit_length()), fault,
                                      values=True), 5)
        print("comp_groups " + json.dumps(out), flush=True)
    from cmsbwt_tpu_torch.ops.sort import check_faults
    check_faults("cuda:0")


def final_sa_sort(idx, merge) -> None:
    """One sort of the head string's final rank, the alternative to
    placing each compacted round's rows in the suffix array
    (``final_sa_sort`` line)."""
    got, sad = [], idx.suffix_array_device

    def keep(*a, **kw):
        out = sad(*a, **kw)
        got.append((out[1].clone(), a[1]))
        return out
    with _Patched((idx, "suffix_array_device", keep)):
        merge()
    isa, L = got[0]
    sort = lambda: idx.stable_argsort((isa,), (idx.key_bits(L),))
    sort()
    print("final_sa_sort " + json.dumps({"L": L, "ms": cs.cuda_ms(sort, 5)}),
          flush=True)


def tail_good_split(dm, merge) -> dict:
    """One merge with tail_good taken apart (device-synced marks): the
    expansion of the pairs (entry to the join sort), the join sort, the
    post-sort gathers (the sort's end to tail_good_join), tail_good_join,
    and the rest (the exact pairs' compaction and sort)."""
    marks = {}
    tg, sort0, join0 = dm.tail_good_dev, dm.stable_argsort, dm.tail_good_join

    def mark(k):
        torch.cuda.synchronize()
        marks.setdefault(k, time.perf_counter())

    def sort(keys, bits, values=False):
        first = "sort0" not in marks and "entry" in marks
        if first:
            mark("sort0")
        out = sort0(keys, bits, values)
        if first:
            mark("sort1")
        return out

    def join(*a):
        mark("join0")
        out = join0(*a)
        mark("join1")
        return out

    def good(*a, **kw):
        mark("entry")
        out = tg(*a, **kw)
        mark("exit")
        return out
    with _Patched((dm, "tail_good_dev", good), (dm, "stable_argsort", sort),
                  (dm, "tail_good_join", join)):
        merge()
    ms = lambda a, b: (marks[b] - marks[a]) * 1e3
    return {"expansion_ms": ms("entry", "sort0"),
            "sort_ms": ms("sort0", "sort1"),
            "gathers_ms": ms("sort1", "join0"),
            "join_ms": ms("join0", "join1"), "rest_ms": ms("join1", "exit"),
            "wall_ms": ms("entry", "exit")}


def stage_peaks(dm, merge) -> dict:
    """One merge with the peak device bytes of each stage
    (torch.cuda.max_memory_allocated, reset at the stage's entry)."""
    peaks = {}

    def spied(k, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            peaks[k] = max(peaks.get(k, 0), torch.cuda.max_memory_allocated())
            return out
        return run
    with _Patched(*[(dm, k, spied(k, getattr(dm, k))) for k in MERGE_STAGES
                    if hasattr(dm, k)]):
        merge()
    return peaks


def merge_child(spec: dict) -> None:
    """One turn of merge_stages_main: the package imported from
    spec["root"]; per shape the jump scan's heads, one merge to warm up,
    MERGE_RUNS merges with head_string_sa and tail_good timed (``merge_run
    {json}`` lines), one merge each for head_string_split,
    tail_good_split and stage_peaks, with spec["full"] the stage marks
    (CMSBWT_PROFILE=1, stderr), head_string_sa, tail_good, tail_exact and
    runs_emit under torch.profiler and bucket_sums_case; then the jump -r
    CLI (``cli_run {json}`` lines)."""
    sys.path.insert(0, spec["root"])
    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index import device as idx
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    tag = spec["tag"]
    print(f"child {tag}: package {pathlib.Path(dm.__file__).parents[1]}",
          flush=True)
    kernels.load()
    for name, lst in spec["shapes"]:
        x_aug, coll = load_inputs(lst)
        res = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
        sn, d = coll.sn, coll.d
        print(f"merge[{name},{tag}]: n={len(x_aug)} sn={sn} h={res.h} "
              f"h_pad={int(res.head_t.shape[0])}", flush=True)
        del x_aug, coll
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        def merge():
            return dm.merge_heads_device_resident(res, d, False,
                                                  want_counter=False)
        merge()
        for i in range(MERGE_RUNS):
            hs, tg = [], []
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with _Patched((dm, "head_string_sa_dev",
                           _synced(dm.head_string_sa_dev, hs)),
                          (dm, "tail_good_dev",
                           _synced(dm.tail_good_dev, tg))):
                t0 = time.perf_counter()
                merge()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            print("merge_run " + json.dumps({
                "shape": name, "tag": tag, "run": i, "merge_device_ms": wall,
                "head_string_sa_ms": hs[0], "tail_good_ms": tg[0],
                "peak_bytes": peak, "peak_per_char": peak / sn,
                "held_before": base}), flush=True)
        split = {"shape": name, "tag": tag,
                 "head_string_sa": head_string_split(dm, idx, merge),
                 "tail_good": tail_good_split(dm, merge)}
        torch.cuda.empty_cache()
        peaks = stage_peaks(dm, merge)
        top = max(peaks, key=peaks.get)
        split["stage_peaks"] = peaks
        split["peak_stage"] = top
        split["peak_per_char"] = peaks[top] / sn
        print("merge_split " + json.dumps(split), flush=True)
        a, kw = capture_rank_step(idx, merge)
        dense_rank_split(kernels, idx, a, kw, pathlib.Path(spec["root"]),
                         spec["full"])
        del a, kw
        if spec["full"]:
            final_sa_sort(idx, merge)
            comp_split(kernels, idx, merge, pathlib.Path(spec["root"]))
            os.environ["CMSBWT_PROFILE"] = "1"
            try:
                merge()
            finally:
                del os.environ["CMSBWT_PROFILE"]
            sys.stderr.flush()
            emitted = []
            orig = {k: getattr(dm, k) for k in (
                "head_string_sa_dev", "tail_good_dev", "tail_exact_dev",
                "runs_emit_dev")}

            def spy(k):
                def run(*a, **kw):
                    if k == "runs_emit_dev":
                        emitted.append(a)
                    print(f"merge[{name}]: {k} under torch.profiler",
                          flush=True)
                    out = {}
                    profiled(lambda: out.setdefault("r", orig[k](*a, **kw)),
                             30)
                    return out["r"]
                return run
            with _Patched(*[(dm, k, spy(k)) for k in orig]):
                merge()
            bucket_sums_case(name, emitted[0])
            emitted.clear()
        del res
        torch.cuda.empty_cache()
        for i in range(CLI_RUNS):
            out = WORK / f"cli_{name}_{tag}_{i}"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if cli.main([lst, "-o", str(out), "--device", "cuda",
                         "--backend", "jump", "-r", "--no-rle-quirk"]):
                raise SystemExit("cli failed")
            wall = time.perf_counter() - t0
            ph = cs.phases_from_log(out.with_suffix(".log"))
            print("cli_run " + json.dumps({
                "shape": name, "tag": tag, "run": i, "wall_s": wall,
                "merge_device_ms": ph.get("merge_device"),
                "phases_ms": ph}), flush=True)
            for f in WORK.glob(out.name + ".*"):
                f.unlink()


def parent_merge_kernels(parent: pathlib.Path):
    """An older checkout's kernels module (its wrappers and its sources,
    built at first use as it builds them), loaded beside this tree's."""
    import importlib.util
    init = parent / "cmsbwt_tpu_torch" / "kernels" / "__init__.py"
    spec = importlib.util.spec_from_file_location("parent_kernels", init)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.load()
    return mod


def ab_turns(tag: str, kname: str, old, timers: dict) -> None:
    """Each of ``timers`` ({label: fn(kernels module) -> ms}) for an older
    checkout's kernels module ``old`` and this tree's, in turns: parent,
    this, this, parent."""
    from cmsbwt_tpu_torch import kernels
    for label, fn in timers.items():
        times = [(who, fn(k)) for who, k in (("parent", old),
                                             ("this", kernels),
                                             ("this", kernels),
                                             ("parent", old))]
        print(f"merge_kernels[{tag}] A/B {kname} {label}: " + ", ".join(
            f"{w} {ms:.3f} ms" for w, ms in times), flush=True)


def fill_case(tag: str, v, op: str, rev: bool, old, reps: int = 5) -> None:
    """running_fill on ``v``: against its plain version (exact), timed as
    the wrapper runs it and alone, beside Tensor.copy_ of the same bytes
    and one 1-D torch.cummax (chip_smoke.fill_times); with ``old`` (an
    older checkout's kernels module), its outputs must be equal, and the
    two kernels are timed in turns, alone and as each wrapper runs it."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops.fill import running_fill_reference
    r = cs.compare("running_fill", tag, "running_fill_reference",
                   lambda: (kernels.running_fill_cuda(v, op, rev),),
                   lambda: (running_fill_reference(v, op, rev),),
                   f"m={v.numel()} {v.dtype} {op}"
                   f"{' reverse' if rev else ''}", 2 * cs.nbytes(v))
    cs.fill_times(kernels, tag, r, v, op, rev)
    if old is None:
        return
    if not torch.equal(old.running_fill_cuda(v, op, rev), r["outputs"][0]):
        raise SystemExit(f"running_fill[{tag}]: the parent's kernel and "
                         "this tree's differ")
    del r
    ab_turns(tag, "running_fill", old, {
        "alone": lambda k: cs.alone_ms(*cs.fill_launch(k, v, op, rev)),
        "as the wrapper runs it": lambda k: cs.cuda_ms(
            lambda: k.running_fill_cuda(v, op, rev), reps)})


def dense_fill(x_aug, sx):
    """The dense scan's PLCP fill on one joint string (ms_dense._fill_ell
    over the lifted irreducible rows): its running_fill input, op and
    direction."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.ops import ms_dense as md
    d = cs.dense_inputs(x_aug, sx)
    rho, m = d["rho"], d["m"]
    ai = d["ai"][:rho]
    h = kernels.lcp_lift_cuda(d["hist"], d["packs"], ai, d["bi"][:rho],
                              d["lv"][:rho], m, lmax=d["lmax"])
    got, orig = [], md.running_fill

    def keep(v, op="max", reverse=False):
        got.append((v, op, reverse))
        return orig(v, op, reverse)
    md.running_fill = keep
    try:
        md._fill_ell(h, ai, d["isa"], m)
    finally:
        md.running_fill = orig
    return got[0]


# the dense scan's PLCP fill: the bench's primary and ecoli_dense shapes,
# unblocked (name, seed, reference chars, docs, SNP rate)
DENSE_FILL_SHAPES = (("primary_dense", 42, 2_000_000, 10, 0.01),
                     ("ecoli_dense", 42, 5_000_000, 20, 0.01))


def merge_kernels_main(only: str | None, parent: pathlib.Path | None,
                       reps: int = 5) -> None:
    """The device merge's kernels on the inputs one merge of the jump
    scan's heads gives them (chip_smoke.MergeCapture), at each shape of
    MERGE_SHAPES: each against its plain version (exact) and timed
    (chip_smoke.merge_kernel_cases: CUDA events over 5 launches, the byte
    bound; running_fill and bucket_sums also alone, beside Tensor.copy_
    of the same bytes and their library calls), then running_fill on
    every fill of that merge; then running_fill at 2^29 + 1 int64 rows
    (``int64_big``) and on the dense scan's PLCP fill at the shapes of
    DENSE_FILL_SHAPES. With ``parent``, its tail_good_join, run_merge,
    bucket_sums and running_fill are timed against this tree's on the
    same inputs, in turns (parent, this, this, parent; ``reps`` launches
    each), after their outputs were found equal."""
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_jump as mj
    kernels.load()
    old = parent_merge_kernels(parent) if parent else None
    want = lambda name: not only or name in only.split(",")
    for name, seed, ref_len, docs, snp in MERGE_SHAPES:
        if not want(name):
            continue
        lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
        x_aug, coll = load_inputs(str(lst))
        res = mj.ms_jump_heads(x_aug, coll.sx, "cuda")
        del x_aug
        with cs.MergeCapture() as cap:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dm.merge_heads_device_resident(res, coll.d, False,
                                           want_counter=False)
            torch.cuda.synchronize()
        print(f"merge_kernels[{name}]: sn={coll.sn} h={res.h}; merge wall "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        del res
        torch.cuda.empty_cache()
        out = cs.merge_kernel_cases(name, cap)
        print(f"merge_kernels[{name}] " + json.dumps(out), flush=True)
        for i, (v, op, rev) in enumerate(cap.fills):
            fill_case(f"{name}_fill{i}", v, op, rev, old, reps)
        if old is not None:
            runs = {"tail_good_join": (cap.join, lambda k, a: k
                                       .tail_good_join_cuda(*a)[:3]),
                    "run_merge": (cap.runs, lambda k, a: k
                                  .run_merge_cuda(*a)[:2]),
                    "bucket_sums": (cap.sums, lambda k, a: k
                                    .bucket_sums_cuda(*a)[:3])}
            for kname, (args, fn) in runs.items():
                a, b = fn(old, args), fn(kernels, args)
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise SystemExit(f"{kname}[{name}]: the parent's kernel "
                                     "and this tree's differ")
                del a, b
                ab_turns(name, kname, old, {
                    "as the wrapper runs it": lambda k: cs.cuda_ms(
                        lambda: fn(k, args), reps)})
            ab_turns(name, "bucket_sums", old, {
                "alone": lambda k: cs.alone_ms(
                    *cs.bucket_sums_launch(k, *cap.sums))})
        del cap
        torch.cuda.empty_cache()
        shutil.rmtree(WORK / name)
    if want("int64_big"):
        for op, rev in (("max", False), ("min", True)):
            v = cs.fill_input(cs.BIG_FILL, torch.int64, 9, 5)
            fill_case(f"int64_{cs.BIG_FILL}_{op}{'_reverse' if rev else ''}",
                      v, op, rev, old, reps)
            del v
            torch.cuda.empty_cache()
    for name, seed, ref_len, docs, snp in DENSE_FILL_SHAPES:
        if not want(name):
            continue
        lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
        x_aug, coll = load_inputs(str(lst))
        fill_case(f"{name}_plcp", *dense_fill(x_aug, coll.sx), old, reps)
        del x_aug, coll
        torch.cuda.empty_cache()
        shutil.rmtree(WORK / name)


# (name, seed, reference chars, docs, SNP rate, extra CLI flags): the bench
# shapes (chip_smoke.write_workload writes bench.make_workload's bytes),
# and one under the JAX package's AUTO_DENSE_MIN_CHARS
ROUTE_SHAPES = (
    ("small_200Kbp_x8", 1, 200_000, 8, 0.01, ()),
    ("toy_lowdiv", 42, 1_000_000, 10, 0.001, ()),
    ("primary", 42, 2_000_000, 10, 0.01, ()),
    ("primary_snp5", 42, 2_000_000, 10, 0.05, ()),
    ("primary_snp10", 42, 2_000_000, 10, 0.10, ()),
    ("sars_stream", 42, 30_000, 1000, 0.005, ("-p", "25000000")),
    ("sars_full", 42, 30_000, 3000, 0.005, ("-p", "80000000")),
    ("500M", 42, 5_000_000, 100, 0.01, ("-r", "--no-rle-quirk")),
)
ROUTE_RUNS = 3


def routes_main(only: str | None, backends: str | None = None) -> None:
    """Every shape of ROUTE_SHAPES through the CLI on each route (jump,
    dense and native; at the two SARS shapes also jump with the host
    merge, the JAX package's rule there),
    ROUTE_RUNS warm runs each in one process: the wall seconds, the .log
    phases, the backend the .log names and, per shape, the probe's absent
    fraction and whether every route wrote the same bytes; then one line,
    "routes summary" and a JSON object: per shape and route the min, mean
    and max seconds."""
    import filecmp
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.engine.probe import kmer_absent_fraction
    kernels.load()
    os.environ["CMSBWT_INDEX_CACHE"] = str(WORK / "index_cache")
    warm = cs.write_workload(WORK / "warm", 1, 200_000, 8, 0.01)
    for be in ("jump", "dense", "native"):            # CUDA set-up, g++
        cli_run(warm, WORK / f"warm_{be}", "--backend", be)
    summary = {}
    for name, seed, ref_len, docs, snp, flags in ROUTE_SHAPES:
        if only and name not in only.split(","):
            continue
        t0 = time.perf_counter()
        lst = cs.write_workload(WORK / name, seed, ref_len, docs, snp)
        x_aug, coll = load_inputs(str(lst), *(
            [int(flags[1])] if flags[:1] == ("-p",) else []))
        t1 = time.perf_counter()
        frac = kmer_absent_fraction(x_aug, coll.sx)
        probe_s = time.perf_counter() - t1
        print(f"routes[{name}]: n={len(x_aug)} sn={coll.sn} written in "
              f"{t1 - t0:.1f} s; probe absent fraction {frac!r} "
              f"({probe_s * 1e3:.1f} ms)", flush=True)
        routes = [("jump", ("--backend", "jump")),
                  ("dense", ("--backend", "dense")),
                  ("native", ("--backend", "native"))]
        if name.startswith("sars"):
            # the JAX package's SARS rule: jump with the host merge
            routes.append(("jump+host_merge", ("--backend", "jump",
                                               "--merge-backend", "host")))
        if backends:
            routes = [r for r in routes if r[0] in backends.split(",")]
        del x_aug, coll
        ext = ".rl_bwt" if "-r" in flags else ".bwt"
        first = None
        for route, rflags in routes:
            walls = []
            for i in range(ROUTE_RUNS):
                out = WORK / name / f"{route}_{i}"
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cli_run(lst, out, *rflags, *flags)
                walls.append(time.perf_counter() - t0)
                text = out.with_suffix(".log").read_text()
                ran = text.split("backend: ")[1].split()[0]
                print(f"routes[{name},{route}] run {i}: wall_s "
                      f"{walls[-1]:.3f}; .log backend {ran}",
                      flush=True)
                res = out.with_suffix(ext)
                if first is None:
                    first = res
                elif not filecmp.cmp(first, res, shallow=False):
                    raise RuntimeError(f"{name}: {route} wrote other bytes "
                                       f"than {first.name}")
                if res != first:
                    res.unlink()
            summary.setdefault(name, {"probe_absent_fraction": frac})[
                route] = {"min_s": min(walls), "max_s": max(walls),
                          "mean_s": sum(walls) / len(walls)}
            torch.cuda.empty_cache()
        print(f"routes[{name}]: every route wrote the same bytes", flush=True)
        shutil.rmtree(WORK / name)
    print("routes summary " + json.dumps(summary), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true",
                    help="profile the dense route instead of the jump route")
    ap.add_argument("--blocked", action="store_true",
                    help="profile the blocked dense scan (500 Mchars)")
    ap.add_argument("--host-merge", action="store_true",
                    help="one ~1.0 Gchar run above the device merge's "
                    "ceiling, through the host merge")
    ap.add_argument("--routes", nargs="?", const="", default=None,
                    metavar="SHAPE",
                    help="time the CLI on the jump, dense and native routes "
                    "at every shape of ROUTE_SHAPES (or at SHAPE alone; "
                    "a comma list names several)")
    ap.add_argument("--backends", default=None, metavar="ROUTE",
                    help="with --routes: only these routes (a comma list "
                    "of jump, dense, native, jump+host_merge)")
    ap.add_argument("--mesh", action="store_true",
                    help="the mesh routes over every visible card (the "
                    "sharded merge, the mesh scan, the giant route)")
    ap.add_argument("--merge-stages", nargs="?", const="", default=None,
                    metavar="SHAPE",
                    help="the device merge at primary and 500 Mchars (or "
                    "at SHAPE alone): head_string_sa and tail_good timed "
                    "and taken apart, each stage's peak bytes, the jump "
                    "-r CLI; alone also stage marks and stages under "
                    "torch.profiler")
    ap.add_argument("--merge-kernels", nargs="?", const="", default=None,
                    metavar="SHAPE",
                    help="the merge's kernels on a real merge's inputs at "
                    "primary and 500 Mchars (or at SHAPE alone), against "
                    "their plain versions and timed; with --parent, its "
                    "kernels against this tree's")
    ap.add_argument("--comp-groups", action="store_true",
                    help="dense_rank_comp's round on made slices of the 500 "
                    "Mchar merge's first compacted round in groups of "
                    "2 .. 8192 rows: by counting, by the bitonic network, "
                    "as committed, and the large path's sort")
    ap.add_argument("--output", nargs="?", const="", default=None,
                    metavar="SHAPE",
                    help="the jump CLI's merge_device and write_output at "
                    "primary and 500 Mchars (or at SHAPE alone); with "
                    "--parent in turns with its checkout's")
    ap.add_argument("--step0", action="store_true",
                    help="with --output: first the output's step 0 in "
                    "--parent's package (this tree's without it)")
    ap.add_argument("--runs", type=int, default=2,
                    help="with --output: CLI runs a turn per shape and "
                    "format")
    ap.add_argument("--cli-only", action="store_true",
                    help="jump route: the CLI runs alone")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="an older checkout's root: with --dense, also "
                    "time its dense kernels against this tree's at both "
                    "shapes; with --merge-stages, its merges in turns with "
                    "this tree's; alone, its jump CLI against this tree's")
    ap.add_argument("--merge-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--output-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.merge_child:
        merge_child(json.loads(args.merge_child))
        return 0
    if args.output_child:
        output_child(json.loads(args.output_child))
        return 0
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    print(card(), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.environ.setdefault("CMSBWT_NATIVE_DIR", str(WORK / "native"))
    try:
        if args.mesh:
            mesh_main()
        elif args.comp_groups:
            comp_groups_main(ROOT)
        elif args.output is not None:
            output_main(args.output or None, args.parent, args.step0,
                        args.runs)
        elif args.merge_stages is not None:
            merge_stages_main(args.merge_stages or None, args.parent)
        elif args.merge_kernels is not None:
            merge_kernels_main(args.merge_kernels or None, args.parent)
        elif args.routes is not None:
            routes_main(args.routes or None, args.backends)
        elif args.host_merge:
            host_merge_main()
        elif args.blocked:
            blocked_main()
        elif args.dense:
            dense_main(args.parent)
        elif args.parent:
            merge_ab(args.parent)
        else:
            jump_main(args.cli_only)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
