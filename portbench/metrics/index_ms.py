"""index_ms: the reference index of a job that builds it (CMSBWT(...) and
its device_index, ending in a synchronise in the traced run), the
benchmark's own span, mean per job over the jobs that ran outside the
profiler."""


def read(run):
    got = [j.index_s for j in run.steady() if j.index_s is not None]
    return sum(got) / len(got) * 1e3 if got else None
