"""head_sa_ms: the program's spans 'sa.round0', 'sa.comp' and 'sa.tail'
(index/device._suffix_array_starts: the head string's first round, each
compacted round and the tail call, each up to its host read, so each holds
its round's device time), host ms per job run outside the profiler
(spans.untraced_ms_per_job). None for a program without these spans."""
from portbench import spans

SPANS = ("sa.round0", "sa.comp", "sa.tail")


def read(run):
    spans.print_idle(run.trace)
    return spans.untraced_ms_per_job(run, SPANS)
