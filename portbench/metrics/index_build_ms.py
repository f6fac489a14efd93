"""index_build_ms: the device time from the start of each of the
program's 'index.build' spans (index/device.build_device_index) to the
end of the benchmark's call around it ('portbench.index', which ends in a
synchronise in the traced run; 'index.load' before it launches nothing),
in the traced stretch, per traced job: the index's kernels, copies and
sets."""
from portbench import spans

SPAN = "index.build"


def read(run):
    t = run.trace
    spans.print_idle(t)
    if t is None or not t.jobs:
        return None
    s = spans.device_s_until(t, SPAN, spans.CALLS[0])
    return s / len(t.jobs) * 1e3 if s > 0 else None
