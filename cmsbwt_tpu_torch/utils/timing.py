"""Spans and counters of the port, and the per-phase timer of a run.

One recorder, three exporters of the same spans:

* ``span(name)`` (a context manager) times its block on the host and adds
  the seconds and one call to this thread's table ``SPANS[name] =
  [seconds, calls]``, keyed by the full dotted name the caller gives
  (``merge.fixup``, ``parse.read.file``). It never synchronises the card.
* While ``torch.profiler`` records, a span opens
  ``record_function("cmsbwt." + name)`` instead: a ``user_annotation``
  event on the same clock as the card's kernels in the exported trace, so
  that the card's work and its idle gaps can be charged to the innermost
  span around them. Its time there carries the profiler's cost, so it is
  left out of the table, which holds the spans run with the profiler off.
  With the profiler off no ``record_function`` is entered.
* With CMSBWT_PROFILE set (read at each span's end), a span synchronises
  the card at its end and prints ``#   <name>: <ms> ms`` to stderr: the
  device-synced stage times of ``_stage_timer`` in
  cmsbwt_tpu/ops/ms_dense.py. Only then does a span synchronise.

``count(name, n)`` adds ``n`` to this thread's ``COUNTS[name]``; sizes
known only on the host (heads, tail pairs, runs) are counted there, and
with CMSBWT_PROFILE set each count prints ``#   <name>: <n>`` to stderr
beside the spans' lines. ``reset()`` clears both tables of the thread
(one job's spans and counts are read between two resets).

``PhaseTimer`` is the port's copy of the one in cmsbwt_tpu/utils/timing.py:
the per-phase wall times a run writes to its ``.log``. Each of its phases
is a span of the phase's name.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled


class _Tables(threading.local):
    def __init__(self):
        self.spans = {}     # name -> [host seconds, calls]
        self.counts = {}    # name -> total


_tls = _Tables()


def __getattr__(name: str):
    """``SPANS`` and ``COUNTS``: the calling thread's tables."""
    if name == "SPANS":
        return _tls.spans
    if name == "COUNTS":
        return _tls.counts
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset() -> None:
    """Clear this thread's spans and counts."""
    _tls.spans.clear()
    _tls.counts.clear()


def count(name: str, n: int) -> None:
    """Add ``n`` to this thread's ``COUNTS[name]``."""
    c = _tls.counts
    c[name] = c.get(name, 0) + n
    if os.environ.get("CMSBWT_PROFILE"):
        print(f"#   {name}: {n}", file=sys.stderr)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class span:
    """``with span(name):`` records the block's host seconds under
    ``SPANS[name]``, or in the profiler's trace while it records (see the
    module's docstring). ``seconds`` holds the block's time after it."""

    __slots__ = ("name", "seconds", "_t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0

    def __enter__(self):
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function("cmsbwt." + self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        profile = os.environ.get("CMSBWT_PROFILE")
        if profile:
            _sync()
        dt = time.perf_counter() - self._t0
        if profile:
            print(f"#   {self.name}: {dt * 1e3:.1f} ms", file=sys.stderr)
        self.seconds = dt
        if self._rf is not None:
            self._rf.__exit__(*exc)
            return False
        row = _tls.spans.get(self.name)
        if row is None:
            _tls.spans[self.name] = [dt, 1]
        else:
            row[0] += dt
            row[1] += 1
        return False


class _Phase(span):
    __slots__ = ("phases",)

    def __init__(self, name: str, phases: list):
        super().__init__(name)
        self.phases = phases

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.phases.append((self.name, self.seconds))
        return False


class PhaseTimer:
    def __init__(self):
        self.phases: list[tuple[str, float]] = []

    def phase(self, name: str) -> span:
        """A span ``name`` whose seconds are appended to ``phases``."""
        return _Phase(name, self.phases)

    def total(self) -> float:
        return sum(t for _, t in self.phases)

    def report(self) -> str:
        lines = [f"{n}: {t * 1000:.1f} ms" for n, t in self.phases]
        lines.append(f"total: {self.total() * 1000:.1f} ms")
        return "\n".join(lines)
