"""scan_ms: the program's TransformResult.timer phase 'ms_scan', mean per
job over the jobs that ran it outside the profiler."""
PHASE = "ms_scan"


def read(run):
    got = [j.phases[PHASE] for j in run.steady() if PHASE in j.phases]
    return sum(got) / len(got) * 1e3 if got else None
