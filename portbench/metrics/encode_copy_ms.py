"""encode_copy_ms: the program's spans 'encode.download' (the output's
bytes copied off the card through the pinned staging pair,
io/output.copy_out) and 'encode.tobytes' (encode_runs's second host copy),
host ms per job run outside the profiler (spans.untraced_ms_per_job)."""
from portbench import spans

SPANS = ("encode.download", "encode.tobytes")


def read(run):
    spans.print_idle(run.trace)
    return spans.untraced_ms_per_job(run, SPANS)
