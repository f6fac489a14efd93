"""merge_idle_ms: the card's idle time under the program's phase
'merge_device' (engine/device_merge.merge_device; a gap charged to the
program's spans around its middle) in the traced stretch, per traced job:
the merge's read-backs, its Python and the allocator."""
from portbench import spans

SPAN = "merge_device"


def read(run):
    t = run.trace
    spans.print_idle(t)
    if t is None or not t.jobs or not any(
            n == SPAN for _, _, n in spans.program(t)):
        return None
    return spans.idle_s_under(t, SPAN) / len(t.jobs) * 1e3
