"""sort_ms: the device time of radix_sort.cu's kernels (radix_hist_kernel,
radix_pass_kernel) in the traced stretch, per traced job."""
KERNELS = ("radix_hist_kernel", "radix_pass_kernel")


def read(run):
    t = run.trace
    if t is None or not t.jobs:
        return None
    s = t.kernel_s(KERNELS)
    return s / len(t.jobs) * 1e3 if s > 0 else None
