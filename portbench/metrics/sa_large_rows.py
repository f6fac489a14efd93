"""sa_large_rows: the program's counter 'sa.large_rows' (the rows that the
head string's compacted rounds hand to the large-group path, in groups of
more than COMP_CAP rows; index/device._suffix_array_starts), per transform
call. The counters hold every call of the thread, traced or not; the
span table counts the calls outside the profiler, and each traced job
made one more. None for a program without the counter."""


def read(run):
    from cmsbwt_tpu_torch.utils import timing
    counts = getattr(timing, "COUNTS", None)
    table = getattr(timing, "SPANS", None)
    if not counts or "sa.large_rows" not in counts or not table \
            or "transform" not in table:
        return None
    calls = table["transform"][1] + sum(j.traced for j in run.jobs)
    return counts["sa.large_rows"] / calls
