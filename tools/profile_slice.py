"""Profile the port on one CUDA card.

    python3 tools/profile_slice.py             # jump + device-merge slice
    python3 tools/profile_slice.py --cli-only  # its step 3 alone
    python3 tools/profile_slice.py --parent DIR  # jump CLI A/B vs DIR
    python3 tools/profile_slice.py --dense     # dense + device-merge slice
    python3 tools/profile_slice.py --dense --parent DIR  # + A/B vs DIR
    python3 tools/profile_slice.py --blocked   # the blocked dense scan
    python3 tools/profile_slice.py --host-merge  # ~1 Gchar, host merge
    python3 tools/profile_slice.py --routes [SHAPE]  # jump/dense/native
    python3 tools/profile_slice.py --mesh      # mesh routes, every card

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
routes (see routes_main): wall seconds, .log phases and the backend it
names, the probe's absent fraction, and a check that every route wrote
the same bytes, then a one-line JSON summary. The auto rule's cuda branch
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

Works in _profile_work/ (gitignored) and deletes it. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
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
    from cmsbwt_tpu_torch.engine.device_merge import \
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
            want, s = _timed(lambda: merge_heads_device_resident(
                jres, coll.d, False))
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
                got, s = _timed(lambda: merge_heads_device_resident(
                    up, coll.d, False, want_counter=False))
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


def routes_main(only: str | None) -> None:
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
    ap.add_argument("--mesh", action="store_true",
                    help="the mesh routes over every visible card (the "
                    "sharded merge, the mesh scan, the giant route)")
    ap.add_argument("--cli-only", action="store_true",
                    help="jump route: the CLI runs alone")
    ap.add_argument("--parent", type=pathlib.Path, default=None,
                    help="an older checkout's root: with --dense, also "
                    "time its dense kernels against this tree's at both "
                    "shapes; alone, its jump CLI against this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.environ.setdefault("CMSBWT_NATIVE_DIR", str(WORK / "native"))
    try:
        if args.mesh:
            mesh_main()
        elif args.routes is not None:
            routes_main(args.routes or None)
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
