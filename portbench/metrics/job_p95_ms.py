"""job_p95_ms: the 95th percentile of the window's job wall times, from the
call to its bytes in host memory (the benchmark's host clock), over the
jobs that ran outside the profiler; at least 20 of them, so that one lies
beyond it. A per-layer metric: its spread between runs is too wide for
an end-to-end bound (PERF.md §2)."""
import statistics


def read(run):
    walls = [j.wall_s for j in run.steady()]
    if len(walls) < 20:
        return None
    return statistics.quantiles(walls, n=20)[18] * 1e3
