"""peak_device_gib: torch.cuda.max_memory_allocated() over the window,
its statistics reset at the window's start, in GiB."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2**30
