"""chars_per_s: the collection chars that became BWT bytes in the window,
over the window's seconds, in Mchars/s (the benchmark's host clock)."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.sn for j in run.jobs) / run.window_s / 1e6
