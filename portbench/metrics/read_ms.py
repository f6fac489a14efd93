"""read_ms: the host read of the collection file onto the card
(io/parse.read_raw: LAST_READ["total_s"] after each job), mean per job
over the jobs that ran outside the profiler."""


def read(run):
    got = [j.read_s for j in run.steady() if j.read_s is not None]
    return sum(got) / len(got) * 1e3 if got else None
