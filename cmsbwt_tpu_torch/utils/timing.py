"""Stage timing and tracing for the port.

``stage_timer`` is the counterpart of ``_stage_timer`` in
cmsbwt_tpu/ops/ms_dense.py: per-stage wall times printed to stderr when
CMSBWT_PROFILE=1. Its clock is thread-local (one pipeline per thread does
not restart another's window) and, on CUDA, each mark synchronises the
device first so a stage is charged for its own kernels.

``maybe_torch_trace`` is the counterpart of ``maybe_jax_trace``
(cmsbwt_tpu/utils/timing.py): a torch.profiler trace of one phase, written
under CMSBWT_TRACE_DIR when that is set.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch

_clock = threading.local()


def stage_timer(device=None):
    """Return ``mark(name)``: print the time since the previous mark on
    this thread (no-op unless CMSBWT_PROFILE is set)."""
    if not os.environ.get("CMSBWT_PROFILE"):
        return lambda name: None
    cuda = torch.device(device).type == "cuda" if device is not None \
        else False
    if cuda:
        torch.cuda.synchronize()
    _clock.t = time.perf_counter()

    def mark(name):
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"#   {name}: {(now - _clock.t) * 1e3:.1f} ms",
              file=sys.stderr)
        _clock.t = now
    return mark


@contextlib.contextmanager
def maybe_torch_trace(phase: str):
    """torch.profiler chrome trace of one phase when CMSBWT_TRACE_DIR is
    set (view in chrome://tracing or Perfetto)."""
    trace_dir = os.environ.get("CMSBWT_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, phase + ".json"))
