"""device_idle_pct: the share of a job's wall time in which no kernel, copy
or set ran on the card: the device's busy time per job in the traced
stretch (torch.profiler, CUPTI), over the mean wall time of the jobs that
ran outside the profiler (recording the host's ops slows the traced jobs'
host side, not the card's work); over the traced stretch's own time a job
where the window held no other job."""
import statistics


def read(run):
    t = run.trace
    if t is None or not t.jobs or t.busy_s() <= 0:
        return None
    walls = [j.wall_s for j in run.jobs if not j.traced] or [
        t.window_s / len(t.jobs)]
    return 100.0 * (1.0 - t.busy_s() / len(t.jobs) / statistics.mean(walls))
