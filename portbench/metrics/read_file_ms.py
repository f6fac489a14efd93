"""read_file_ms: the program's span 'parse.read.file' (the collection
file's reads into the pinned staging pair, io/parse.read_raw), host ms per
job run outside the profiler (spans.untraced_ms_per_job)."""
from portbench import spans

SPANS = ("parse.read.file",)


def read(run):
    spans.print_idle(run.trace)
    return spans.untraced_ms_per_job(run, SPANS)
