"""setup_s: from the start of the process to the start of the window:
imports, the inputs made from the seed, the kernels' build (first run in
a checkout), the held index and the warm-up jobs."""


def read(run):
    return run.setup_s
