"""Profile the port on one CUDA card.

    python3 tools/profile_slice.py             # jump + device-merge slice
    python3 tools/profile_slice.py --cli-only  # its step 3 alone
    python3 tools/profile_slice.py --dense     # dense + device-merge slice

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
the same way.

The dense mode prints the card's name and power limit, then at the
primary shape: the CLI (--backend dense) three times in one process (wall
seconds and the .log phases), the dense scan stage by stage
(CMSBWT_PROFILE=1, device-synced marks, on stderr), and one dense scan
under torch.profiler (wall ms, device ms, top operators by device time).
Then once at the bench's ecoli_dense shape (5 Mbp x 20 docs at 1% SNP,
seed 42, about 100 Mchars, narrow seed): the CLI with -r, its bytes held
to the C++ reference tool's (baseline/cms-bwt-ref), its phases, the stage
split, the peak device memory (torch.cuda.max_memory_allocated) of the
CLI run and of the scan alone, and both per joint char.

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


def dense_main() -> None:
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.ops import ms_dense as md
    kernels.load()
    lst = cs.write_workload(WORK / "primary", 42, 2_000_000, 10, 0.01)
    for i in range(3):
        cli_run(lst, WORK / f"p{i}", "--backend", "dense")
    x_aug, coll = load_inputs(str(lst))
    stage_split(x_aug, coll.sx, "primary")
    print("dense scan under torch.profiler (primary):")
    profiled(lambda: md.ms_dense_heads_on_device(x_aug, coll.sx, "cuda"))
    del x_aug, coll

    lst = cs.write_workload(WORK / "ecoli", 42, 5_000_000, 20, 0.01)
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


def jump_main(cli_only: bool) -> None:
    lst = cs.write_workload(WORK, 42, 2_000_000, 10, 0.01)
    if not cli_only:
        kernel_sweep(lst)
    for lanes in (4096, 32768, 4096, 32768):
        cli_run(lst, WORK / f"t{lanes}", "--lanes", str(lanes))
    if not cli_only:
        merge_profile(lst)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dense", action="store_true",
                    help="profile the dense route instead of the jump route")
    ap.add_argument("--cli-only", action="store_true",
                    help="jump route: the CLI runs alone")
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
        if args.dense:
            dense_main()
        else:
            jump_main(args.cli_only)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
