"""index_load_ms: the program's span 'index.load' (the reference read and
augmented on the host, in CMSBWT(...)), host ms per job run outside the
profiler (spans.untraced_ms_per_job)."""
from portbench import spans

SPANS = ("index.load",)


def read(run):
    spans.print_idle(run.trace)
    return spans.untraced_ms_per_job(run, SPANS)
