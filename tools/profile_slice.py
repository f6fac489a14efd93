"""Profile the port's jump + device-merge slice on one CUDA card, at the
bench's primary shape (2 Mbp reference x 10 docs at 1% SNP).

    python3 tools/profile_slice.py

Prints, each on its own lines:

1. the card's name and power limit (nvidia-smi);
2. the ms_jump_scan kernel alone at 4096 .. 131072 lanes: mean device ms
   over 5 launches (CUDA events), after one warm launch;
3. the CLI (--device cuda) at lanes 4096, 32768, 4096, 32768 in one
   process: wall seconds and the phase split of each run's .log;
4. merge_device stage by stage (CMSBWT_PROFILE=1: device-synced marks, on
   stderr) at 32768 lanes;
5. one merge under torch.profiler: wall ms, the sum of device kernel and
   copy time, and the top operators by device time.

Works in _profile_work/ (gitignored) and deletes it. Imports nothing of
JAX.
"""
from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_slice: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cmsbwt_tpu_torch import cli, kernels
    from cmsbwt_tpu_torch.engine import device_merge as dm
    from cmsbwt_tpu_torch.engine.pipeline import load_inputs
    from cmsbwt_tpu_torch.index.device import build_device_index
    from cmsbwt_tpu_torch.ops import ms_jump as mj

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    os.environ.setdefault("CMSBWT_NATIVE_DIR", str(WORK / "native"))
    try:
        lst = cs.write_workload(WORK, 42, 2_000_000, 10, 0.01)
        x_aug, coll = load_inputs(str(lst))
        kernels.load()
        ix = build_device_index(x_aug, "cuda")
        n, sn = ix.n, coll.sn
        gmax = mj.build_gmax_table(ix.plcp, n)
        for lanes in SWEEP:
            split = mj.split_lanes(coll.sx, lanes, 64, "cuda")
            states = iter([split.init_state(n) for _ in range(6)])
            last = {}

            def launch():
                last["st"] = kernels.ms_jump_scan_cuda(
                    ix.x_padded, ix.sa, ix.isa, ix.jump, gmax,
                    split.sx_padded, next(states), split.ends_dev, n=n,
                    sn=sn, cap=split.cap, window=64,
                    rounds=mj._bs_rounds(n))
            launch()
            ms = cs.cuda_ms(launch, 5)
            print(f"kernel lanes={lanes} cap={split.cap} ms={ms:.3f} "
                  f"viol={bool(last['st']['viol'].any())}", flush=True)
        del ix, gmax

        for lanes in (4096, 32768, 4096, 32768):
            out = WORK / f"t{lanes}"
            t0 = time.perf_counter()
            cli.main([str(lst), "-o", str(out), "--device", "cuda",
                      "--lanes", str(lanes)])
            print(f"slice lanes={lanes} wall_s={time.perf_counter() - t0:.3f}"
                  " phases_ms " + json.dumps(cs.phases_from_log(
                      out.with_suffix(".log"))), flush=True)

        res = mj.ms_jump_heads(x_aug, coll.sx, "cuda", lanes=32768)
        os.environ["CMSBWT_PROFILE"] = "1"
        print("merge stages (stderr, lanes=32768):", flush=True)
        dm.merge_heads_device_resident(res, coll.d, False, want_counter=False)
        del os.environ["CMSBWT_PROFILE"]
        sys.stderr.flush()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dm.merge_heads_device_resident(res, coll.d, False,
                                           want_counter=False)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ka = prof.key_averages()
        # device-side events only: an operator's row repeats its kernels' time
        dev_us = sum(e.self_device_time_total for e in ka
                     if e.device_type == DeviceType.CUDA)
        print(f"merge profiled wall_ms={wall:.1f} device_ms={dev_us / 1e3:.1f}"
              " (wall includes the profiler's own start-up)")
        print(ka.table(sort_by="self_device_time_total", row_limit=22,
                       max_name_column_width=48))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
