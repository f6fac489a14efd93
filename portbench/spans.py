"""The program's own spans, in the traced stretch (devtrace.Trace) and in
its own table, for the per-layer metrics that read them.

The port records its spans (utils/timing.span) as ``record_function``
annotations named ``cmsbwt.<name>`` while the profiler runs: host events
on the same clock as the card's kernels, kept in ``Trace.host`` beside the
benchmark's own spans and the host's ops. Span names are given here
without the ``cmsbwt.`` prefix. A time lies under ``prefix`` where a
program span open at it is named ``prefix`` or ``prefix.<...>``, so the
stages inside a phase (``merge.fixup`` inside ``merge_device``) lie under
it.

* ``untraced_ms_per_job(run, names)``: the host ms of the program spans
  so named per job run outside the profiler, from the program's own table
  (utils/timing.SPANS, kept in the thread that ran the jobs and reads the
  metrics, and holding only spans run with the profiler off): its totals
  over its ``transform`` calls. The warm-up's jobs are among them, as the
  harness keeps no table a job (PERF.md, Open questions);
* ``idle_s_under(trace, prefix)``: the idle time of the gaps (the stretch
  with nothing on the device, ``Trace.gaps``) whose middle lies under
  ``prefix``;
* ``idle_by_span(trace, inside)``: the idle time by the innermost program
  span around each gap's middle ('' where none is open), over the gaps
  whose middle lies in a host span named in ``inside`` (all where it is
  empty);
* ``device_s_until(trace, name, until)``: the device time from the start
  of each program span ``name`` to the end of the host span ``until``
  around it.
* ``print_idle(trace)``: prints the stretch's ``idle by program span``
  line on stderr, once a trace, from whichever reader of a program span
  runs first (the harness prints no such line itself).

A trace of a program without spans has none (``program`` is empty).
"""
from __future__ import annotations

import json
import sys

PREFIX = "cmsbwt."
# the benchmark's spans around its calls into the program (harness.py)
CALLS = ("portbench.index", "portbench.transform")


def program(trace) -> list:
    """The program's spans (start us, end us, name), a parent before the
    children that start with it."""
    return sorted(((t0, t1, n[len(PREFIX):]) for t0, t1, n in trace.host
                   if n.startswith(PREFIX)), key=lambda s: (s[0], -s[1]))


def _stacks(spans: list, times: list):
    """For each of ``times`` (sorted), the spans (sorted by start) opened
    by then and not seen closed, the last opened last; yields the live
    stack, to be read before the next item."""
    stack, i = [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        yield stack


def _open_at(stack: list, t: float) -> list:
    """The names of the spans of ``stack`` open at ``t``, outermost
    first."""
    return [name for _, end, name in stack if end >= t]


def _under(chain: list, prefix: str) -> bool:
    dotted = prefix + "."
    return any(n == prefix or n.startswith(dotted) for n in chain)


def untraced_ms_per_job(run, names):
    """None where the program keeps no table (an older program) or no job
    ran outside the profiler."""
    from cmsbwt_tpu_torch.utils import timing
    table = getattr(timing, "SPANS", None)
    if not table or "transform" not in table:
        return None
    s = sum(table[n][0] for n in names if n in table)
    return s / table["transform"][1] * 1e3 if s > 0 else None


def _gap_chains(trace) -> list:
    """Each idle gap's (seconds, middle us, names of the program spans open
    at its middle)."""
    gaps = trace.gaps()
    mids = [(g0 + g1) / 2 for g0, g1 in gaps]
    return [((g1 - g0) * 1e-6, t, _open_at(st, t)) for (g0, g1), t, st
            in zip(gaps, mids, _stacks(program(trace), mids))]


def idle_s_under(trace, prefix: str) -> float:
    return sum(s for s, _, chain in _gap_chains(trace)
               if _under(chain, prefix))


def idle_by_span(trace, inside=()) -> dict:
    inside = set(inside)
    chains = _gap_chains(trace)
    if inside:
        keep = [bool(inside.intersection(_open_at(st, t))) for (_, t, _), st
                in zip(chains, _stacks(trace.host,
                                       [t for _, t, _ in chains]))]
    else:
        keep = [True] * len(chains)
    by = {}
    for (s, _, chain), k in zip(chains, keep):
        if k:
            name = chain[-1] if chain else ""
            by[name] = by.get(name, 0.0) + s
    return by


def device_s_until(trace, name: str, until: str) -> float:
    lo, hi = trace.lo, trace.hi
    outer = [(t0, t1) for t0, t1, n in trace.host if n == until]
    total = 0.0
    for s0, _, n in program(trace):
        if n != name:
            continue
        ends = [t1 for t0, t1 in outer if t0 <= s0 <= t1]
        if not ends:
            continue
        w0, w1 = max(s0, lo), min(max(ends), hi)
        for t0, t1, _ in trace.device:
            t0, t1 = max(t0, w0), min(t1, w1)
            if t1 > t0:
                total += t1 - t0
    return total * 1e-6


_printed = [None]       # the trace whose line was printed


def print_idle(trace) -> None:
    if trace is None or _printed[0] is trace or not program(trace):
        return
    _printed[0] = trace
    by = idle_by_span(trace)
    calls = idle_by_span(trace, CALLS)
    inside = sum(calls.values())
    staged = sum(v for k, v in calls.items() if k not in ("", "transform"))
    print(f"idle by program span: idle_s {sum(by.values())} in_calls_s "
          f"{inside} staged_s {staged} staged_pct "
          f"{100 * staged / inside if inside else None} "
          + json.dumps(dict(sorted(by.items(), key=lambda x: -x[1]))),
          file=sys.stderr)
