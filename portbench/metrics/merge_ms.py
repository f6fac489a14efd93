"""merge_ms: the program's TransformResult.timer phase 'merge_device', mean per
job over the jobs that ran it outside the profiler."""
PHASE = "merge_device"


def read(run):
    got = [j.phases[PHASE] for j in run.steady() if PHASE in j.phases]
    return sum(got) / len(got) * 1e3 if got else None
