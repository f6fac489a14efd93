"""The traced stretch of a run: a torch.profiler (CUPTI) trace of whole
jobs, written to a chrome-trace file and read back into what the
per-layer metrics need.

The profiler records every host op beside the card's activity: with
torch 2.11 a trace of the card's activity alone, or with only the
``record_function`` spans on the host, gives every kernel, copy and
runtime call a start and a length of 0. Recording the ops costs the
traced jobs a few per cent of their wall time at these cells' sizes
(the run prints their median beside the untraced jobs'), which is why
``device_idle_pct`` divides the trace's busy time by the untraced jobs'
wall time.

* ``Trace.load(path)`` reads the file: the device's intervals (kernels,
  copies and sets), the host's spans and ops, and the stretch, which runs
  from the start of the first ``JOB_SPAN`` to the end of the last. A job
  ends with its bytes in host memory, so all its device work lies inside.
* ``busy_s``: the union of the device's intervals in the stretch;
  ``kernel_s(names)``: the device time of the kernels so named (by
  ``kernel_id``); ``top_ops`` and ``idle_gaps``: the breakdown's lists
  (kernels by ``kernel_id``, copies and sets by their names), the gaps
  named by the innermost host span or op around each gap's middle.
"""
from __future__ import annotations

import dataclasses
import json

JOB_SPAN = "portbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def kernel_id(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: 'void (anonymous namespace)::radix_pass_kernel
    <8, unsigned int, 0>((anonymous namespace)::Pass)' -> 'radix_pass_kernel'.
    """
    head, depth = [], 0
    for ch in name.replace("(anonymous namespace)", ""):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            if ch == "(":
                break
            head.append(ch)
    words = "".join(head).split()
    return words[-1].split("::")[-1] if words else name


def _events(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _spans(events: list, cats) -> list:
    """(start us, end us, name) of the complete events of ``cats``, sorted;
    a kernel named by its ``kernel_id``."""
    out = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") != "X" or "dur" not in e or cat not in cats:
            continue
        t0 = float(e["ts"])
        name = e.get("name", "")
        out.append((t0, t0 + float(e["dur"]),
                    kernel_id(name) if cat == "kernel" else name))
    out.sort()
    return out


def _union(intervals) -> list:
    """The (start, end) pieces that sorted intervals cover together."""
    out = []
    for t0, t1, *_ in intervals:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


@dataclasses.dataclass
class Trace:
    device: list            # (start us, end us, kernel id or name), sorted
    host: list              # (start us, end us, name), sorted
    jobs: list              # (start us, end us) of each JOB_SPAN

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        host = _spans(events, HOST_CATS)
        return cls(_spans(events, DEVICE_CATS),
                   [h for h in host if h[2] != JOB_SPAN],
                   [(t0, t1) for t0, t1, n in host if n == JOB_SPAN])

    @classmethod
    def load(cls, path) -> "Trace":
        return cls.from_events(_events(path))

    @property
    def lo(self) -> float:
        return min((t0 for t0, _ in self.jobs), default=0.0)

    @property
    def hi(self) -> float:
        return max((t1 for _, t1 in self.jobs), default=0.0)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    def _inside(self):
        lo, hi = self.lo, self.hi
        for t0, t1, name in self.device:
            t0, t1 = max(t0, lo), min(t1, hi)
            if t1 > t0:
                yield t0, t1, name

    def busy_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in _union(self._inside())) * 1e-6

    def kernel_s(self, names) -> float:
        names = set(names)
        return sum(t1 - t0 for t0, t1, n in self._inside()
                   if n in names) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for t0, t1, n in self._inside():
            by[n] = by.get(n, 0.0) + (t1 - t0) * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def gaps(self) -> list:
        """(start us, end us) of each stretch of the window with nothing
        on the device."""
        out, end = [], self.lo
        for t0, t1 in _union(self._inside()):
            if t0 > end:
                out.append((end, t0))
            end = max(end, t1)
        if self.hi > end:
            out.append((end, self.hi))
        return out

    def host_at(self, times: list) -> list:
        """For each of ``times`` (sorted), the innermost host span or op
        around it (the last opened of those still open), or 'host' where
        none is."""
        out, stack, i = [], [], 0
        for t in times:
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out.append(stack[-1][2] if stack else "host")
        return out

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time by what the host was doing, largest first."""
        gaps = self.gaps()
        by = {}
        for (g0, g1), label in zip(gaps, self.host_at(
                [(g0 + g1) / 2 for g0, g1 in gaps])):
            by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]
