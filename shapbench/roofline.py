"""A kernel family's share of its roofline over the window: the least time
of the launches the cell's shapes need (``costs.clip_plan``, per clip,
times the clips completed) over the profiler's device time of the kernels
named by the metric. The profiler's launch count is checked against the
plan and the port's counters: where the profiler dropped records, the
least time is taken for the launches it kept (a share of the plan's, the
launches of one clip being alike in cost per family); where it kept none,
nothing is read."""

from __future__ import annotations

import sys

from shapbench.costs import clip_plan


def roofline_pct(w, family: str, names, counters):
    if w.trace is None or not w.clips:
        return None
    ops = w.trace.kernels(names)
    if not ops:
        return None
    _, _, least_ms, launches = clip_plan(w.workload, w.arch)[family]
    planned = launches * w.clips
    counted = sum(w.launches.get(c, 0) for c in counters)
    least = least_ms * w.clips
    if counted and counted != planned:
        print(f"shapbench: {family}: the port launched {counted} kernels, the plan has "
              f"{planned}", file=sys.stderr)
    if len(ops) != planned:
        print(f"shapbench: {family}: the profiler recorded {len(ops)} of {planned} launches",
              file=sys.stderr)
        least *= len(ops) / planned
    device_ms = sum(e - s for _, s, e in ops) / 1e6
    return 100.0 * least / device_ms
