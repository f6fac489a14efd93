"""One run of one benchmark cell: set-up, a measured window of jobs, the
check of what the jobs produced, and the result's line.

Everything that belongs to one cell, configuration or metric is data the
harness finds by name under the benchmark's folder:

* a cell is BENCHMARK.json's entry: a configuration and a traffic mix;
* ``traffic/<traffic>.json``: the jobs (the output format, whether a job
  builds the reference index or the index is held from set-up; a job
  takes the configuration's collection files in turn), which files are
  rewritten before each job (``rewrite``), the jobs traced, the jobs
  checked, and the program's settings (``program``: fields of its
  Config);
* the configuration's ``file`` (``configs/<config>.json``): the sizes the
  generator (workload.py) makes the files from;
* ``metrics/<metric>.py``: a reader, ``read(run) -> number | None``, for
  each metric that BENCHMARK.json lists, whether end to end or per layer.

A run (``run_cell``):
1. makes the configuration's FASTA files from the seed, in ``$TMPDIR``
   (else ``portbench_out/`` in the checkout), and removes them at the end;
2. warms up with ``warm_rounds`` jobs of each collection file (the held
   index is built first);
3. runs jobs back to back, one at a time, until ``seconds`` have passed
   (the job running then finishes inside the window). Before each job
   the files it reads get a new version (workload.Rewriter), so that no
   job reads what an earlier one read. With ``trace`` the first
   ``trace_jobs`` jobs run under torch.profiler and the trace goes to
   ``portbench_out/trace-<cell>-<seed>.json`` (devtrace.py); each job's
   times and counters go to ``portbench_out/jobs-<cell>-<seed>.json``;
4. once the window has closed: reads the peak memory, refuses JAX in
   ``sys.modules``, frees the program's state, and takes the files back
   to the version each of ``check_jobs`` jobs of each file (drawn from
   the seed) read, where the plain reference (reference.py) works out
   its .rl_bwt (or .bwt) again on the same device; it compares those
   jobs' bytes, and every job's collection length (``sn``, which the
   rewrites keep) against the reference's;
5. prints the checked numbers beside their limits on stderr and returns
   the result (``line``), which ``run.py`` prints as its last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import pathlib
import resource
import shutil
import statistics
import sys
import tempfile
import time
import traceback

import numpy as np

from . import guard, reference, workload
from .devtrace import JOB_SPAN, Trace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = "portbench_out"
# the numbers compared, each with its limit: exact output, so 0
LIMITS = {"mismatch_bytes": 0, "wrong_sn_jobs": 0, "failed_jobs": 0}


class RunError(Exception):
    """A run that cannot give a result (exit code ``code``)."""

    def __init__(self, msg: str, code: int = 2):
        super().__init__(msg)
        self.code = code


@dataclasses.dataclass
class Job:
    input: int                  # its collection file, by index
    wall_s: float
    sn: int
    file_bytes: int
    phases: dict                # TransformResult.timer's phases, s
    read_s: float | None        # io/parse.LAST_READ['total_s']
    runs: int | None            # io/output.LAST_WRITE['runs']
    rle: bool
    index_s: float | None       # the index a job builds, s
    out_len: int
    version: int                # the input files' version it read
    traced: bool
    cpu_s: float                # the process's CPU time in the job
    minflt: int                 # its minor page faults in the job


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    traffic: dict
    config: dict
    setup_s: float
    window_s: float
    jobs: list
    launches: dict | None       # kernel launches in the window, by kernel
    peak_bytes: int | None
    trace: Trace | None
    skip_window: int

    def steady(self) -> list:
        """The jobs that ran outside the profiler (all of them where none
        did): the traced jobs carry its overhead."""
        return [j for j in self.jobs if not j.traced] or self.jobs


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    """BENCHMARK.json's ``key`` metrics that the cell reports."""
    return [m for m in bench.get(key, [])
            if cell in m.get("workloads", [cell])]


def reader(root: pathlib.Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.exists():
        raise RunError(f"no reader for metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def definitions(root: pathlib.Path, name: str):
    """BENCHMARK.json, the cell's entry, its traffic and its
    configuration."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise RunError(f"unknown workload {name!r}; BENCHMARK.json has "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{entry['traffic']}.json")
    config = load_json(root / configs[entry["config"]]["file"])
    return bench, entry, traffic, config


def _by_phase(jobs: list) -> dict:
    """Each phase's seconds over the jobs, and the host read's."""
    out = {"read": [j.read_s for j in jobs if j.read_s is not None]}
    for j in jobs:
        for p, v in j.phases.items():
            out.setdefault(p, []).append(v)
    return {p: v for p, v in out.items() if v}


def _usage() -> tuple[float, int, int]:
    """The process's CPU seconds, minor page faults and involuntary
    context switches so far."""
    u = resource.getrusage(resource.RUSAGE_SELF)
    return u.ru_utime + u.ru_stime, u.ru_minflt, u.ru_nivcsw


def _steal() -> tuple[int, int] | None:
    """The host's stolen and total CPU ticks so far (/proc/stat), or None
    where there is no such file."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (ticks[7] if len(ticks) > 7 else 0), sum(ticks)


def _reservoir(rng, kept: list, m: int, k: int, item) -> None:
    """Keep ``item``, the m-th (from 1) of its kind, in a uniform sample of
    ``k`` of them."""
    if len(kept) < k:
        kept.append(item)
    else:
        r = int(rng.integers(0, m))
        if r < k:
            kept[r] = item


def check_outputs(files: list, jobs: list, sample: list, rle: bool,
                  dev, rewriter) -> tuple[dict, set]:
    """Each sampled job's output against the reference's, worked out on
    ``dev`` from the files taken back to the version the job read, and
    every job's sn against the reference's sn of its file: the checks'
    numbers and the jobs found wrong."""
    import torch
    mismatch, failed, sn_of = 0, set(), {}
    picked = sorted(((v, f, i, out) for f in range(len(files))
                     for i, v, out in sample[f]), reverse=True)
    for v, f, i, out in picked:
        rewriter.rewind(v)
        sn_of[f], want = reference.output_of_file(files[f], dev, rle)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        m = reference.mismatch_bytes(out, want)
        mismatch = max(mismatch, m)
        if m:
            failed.add(i)
    wrong = {i for i, j in enumerate(jobs)
             if j.input in sn_of and j.sn != sn_of[j.input]}
    return ({"mismatch_bytes": mismatch, "wrong_sn_jobs": len(wrong)},
            failed | wrong)


def run_cell(root: pathlib.Path, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t0: float | None = None, program: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result's dict. Raises RunError
    where a run gives no result. ``program`` overrides fields of the
    traffic's program settings (the control's path, control.py)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench, entry, traffic, config = definitions(root, name)
    e2e = cell_metrics(bench, name, "end_to_end")
    per_layer = cell_metrics(bench, name, "per_layer")
    readers = {m["name"]: reader(root, m["name"])
               for m in (per_layer if trace else e2e)}
    import torch
    chips = int(entry.get("chips", 1))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: torch.cuda.is_available() is "
                           "False")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")
        # the program's kernel libraries, built at first use, stay in the
        # checkout at a fixed place
        os.environ["CMSBWT_TORCH_BUILD_DIR"] = str(
            root / "cmsbwt_tpu_torch" / "kernels" / "build")
    from cmsbwt_tpu_torch import kernels
    from cmsbwt_tpu_torch.config import Config
    from cmsbwt_tpu_torch.io import output, parse
    from cmsbwt_tpu_torch.models.cms_bwt import CMSBWT

    dev = torch.device(device)
    rle = traffic["output"] == "rl_bwt"
    per_job_index = traffic["index"] == "per_job"
    cfg = Config(**{**traffic.get("program", {}), **(program or {})})
    base = os.environ.get("TMPDIR") or str(root / OUT)
    os.makedirs(base, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"portbench-{name}-",
                                        dir=base))
    try:
        marks = {"imports_s": time.perf_counter() - t0}
        ref, files = workload.make_inputs(config, seed, tmp)
        sizes = [p.stat().st_size for p in files]
        marks["inputs_s"] = time.perf_counter() - t0

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        rw = dict(traffic.get("rewrite", {}))
        rewrites = rw.pop("files", [])
        rewriter = workload.Rewriter(seed, **rw)

        def rewrite_paths(f: int) -> list:
            return [{"collection": files[f], "reference": ref}[k]
                    for k in rewrites]

        held = None
        if not per_job_index:
            held = CMSBWT(str(ref), cfg, device)
            held.device_index
        marks["index_s"] = time.perf_counter() - t0

        def job(i: int, traced: bool = False) -> tuple[Job, bytes]:
            f = i % len(files)
            parse.LAST_READ.clear()
            output.LAST_WRITE.clear()
            u0 = _usage()
            s0 = time.perf_counter()
            index_s = None
            if per_job_index:
                with torch.profiler.record_function("portbench.index"):
                    model = CMSBWT(str(ref), cfg, device)
                    model.device_index
                    if trace:       # index_ms: the index's own time
                        sync()
                index_s = time.perf_counter() - s0
            else:
                model = held
            with torch.profiler.record_function("portbench.transform"):
                r = model.transform(str(files[f]), rle=rle)
            wall = time.perf_counter() - s0
            u1 = _usage()
            out = r.rle if rle else r.bwt
            return Job(input=f, wall_s=wall, sn=r.sn, file_bytes=sizes[f],
                       phases=dict(r.timer.phases),
                       read_s=parse.LAST_READ.get("total_s"),
                       runs=output.LAST_WRITE.get("runs"), rle=rle,
                       index_s=index_s, out_len=len(out),
                       version=rewriter.version, traced=traced,
                       cpu_s=u1[0] - u0[0], minflt=u1[1] - u0[1]), out

        # warm-up: every file, warm_rounds times
        for i in range(len(files) * int(traffic.get("warm_rounds", 1))):
            job(i)
        del i
        sync()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = dict(kernels.LAUNCHES)
        setup_s = time.perf_counter() - t0

        rng = np.random.default_rng([workload.seed_of(seed), 1])
        k = int(traffic.get("check_jobs", 1))
        sample = [[] for _ in files]   # (job index, version, bytes) a file
        seen = [0] * len(files)
        jobs: list[Job] = []
        errors: list[str] = []

        def step(traced: bool = False) -> bool:
            i = len(jobs)
            try:
                if rewrites:
                    rewriter.next(rewrite_paths(i % len(files)))
                if traced:
                    with torch.profiler.record_function(JOB_SPAN):
                        j, out = job(i, True)
                else:
                    j, out = job(i)
            except Exception:                # counted, and the run ends
                errors.append(traceback.format_exc())
                return False
            jobs.append(j)
            seen[j.input] += 1
            _reservoir(rng, sample[j.input], seen[j.input], k,
                       (i, j.version, out))
            return True

        prof, ok = None, True
        host0 = _usage(), _steal()
        w0 = time.perf_counter()
        if trace:       # the first jobs of the window, whole, traced
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                for _ in range(int(traffic.get("trace_jobs", 1))):
                    ok = step(True)
                    if not ok:
                        break
        while ok and time.perf_counter() - w0 < seconds:
            ok = step()
        window_s = time.perf_counter() - w0
        host1 = _usage(), _steal()
        attempted = len(jobs) + len(errors)
        peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None)
        launches = {kk: v - before.get(kk, 0)
                    for kk, v in kernels.LAUNCHES.items()}
        bad = guard.loaded()
        if bad:
            raise RunError("JAX or the JAX package was loaded: "
                           + ", ".join(bad), code=3)
        out_dir = root / OUT
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"jobs-{name}-{seed}.json", "w") as f:
            json.dump([dataclasses.asdict(j) for j in jobs], f)
        tr = None
        if prof is not None:
            path = out_dir / f"trace-{name}-{seed}.json"
            prof.export_chrome_trace(str(path))
            del prof
            tr = Trace.load(path)
            traced_ms = [j.wall_s * 1e3 for j in jobs if j.traced]
            steady_ms = [j.wall_s * 1e3 for j in jobs if not j.traced]
            if traced_ms and steady_ms:
                print(f"traced jobs' median ms {statistics.median(traced_ms)}"
                      f" untraced median ms {statistics.median(steady_ms)}",
                      file=sys.stderr)

        # the program's state goes before the reference runs
        del held, job, step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        c0 = time.perf_counter()
        checks, failed = check_outputs(files, jobs, sample, rle, dev,
                                       rewriter)
        checks["failed_jobs"] = len(errors)
        check_s = time.perf_counter() - c0
        correct = bool(jobs) and all(checks[c] <= LIMITS[c]
                                     for c in LIMITS)
        run = Run(traffic=traffic, config=config, setup_s=setup_s,
                  window_s=window_s, jobs=jobs, launches=launches,
                  peak_bytes=peak, trace=tr, skip_window=cfg.skip_window)
        units = {m["name"]: m["unit"] for m in (per_layer if trace else e2e)}
        metrics = {}
        for mname, read in readers.items():
            v = read(run)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": units[mname]}
        dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                    "kind": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                    "count": chips, "memory_peak_bytes": peak or 0}
        line = {"correct": correct, "attempted": attempted,
                "failed": len(failed) + len(errors), "metrics": metrics,
                "device": dev_info}
        if tr is not None:
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
            line["breakdown"] = {"device_ops": tr.top_ops(),
                                 "idle_gaps": tr.idle_gaps()}
        line["checks"] = {c: {"value": checks[c], "limit": LIMITS[c]}
                          for c in LIMITS}
        for e in errors:
            print(e, file=sys.stderr)
        n = max(len(jobs), 1)
        steal = (100 * (host1[1][0] - host0[1][0])
                 / max(host1[1][1] - host0[1][1], 1)
                 if host0[1] and host1[1] else None)
        print(f"host in the window: cpu_s/job "
              f"{(host1[0][0] - host0[0][0]) / n} minflt/job "
              f"{(host1[0][1] - host0[0][1]) / n} ivcsw/job "
              f"{(host1[0][2] - host0[0][2]) / n} steal_pct {steal} "
              f"affinity {sorted(os.sched_getaffinity(0))}", file=sys.stderr)
        print(f"jobs {len(jobs)} window_s {window_s} setup_s {setup_s} "
              f"(at {marks}) check_s {check_s} sampled "
              f"{[len(s) for s in sample]}", file=sys.stderr)
        if len(jobs) >= 2:
            print("job_ms quartiles " + " ".join(
                f"{q * 1e3:.3f}" for q in statistics.quantiles(
                    [j.wall_s for j in jobs], n=4)) + " phases_ms medians "
                + " ".join(f"{p}={statistics.median(v) * 1e3:.3f}"
                           for p, v in _by_phase(jobs).items()),
                file=sys.stderr)
        for c in LIMITS:
            print(f"check {c} {checks[c]} limit {LIMITS[c]}",
                  file=sys.stderr)
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv, t0: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        line = run_cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                        t0=t0)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return e.code
    print(json.dumps(line), flush=True)
    return 0
