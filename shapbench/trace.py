"""The traced window: ``torch.profiler`` over the timed call, read into
device operations and host operations on one clock.

On a card only the CUDA activity is traced (the device's operations and
the host's CUDA runtime and driver calls): on an H100 host, tracing every
host operator as well stretched the bf16 cell's window by 14% and took
85 s to stop and read. ``busy_s``
is the union of the device operations' intervals inside the window (not a
sum: operations may overlap), ``window_s`` the window's length: the span
of the ``shapbench.window`` annotation where the profiler records it,
else the span of everything it recorded. Idle gaps are the holes in that
union, each named by the innermost host call that was running at its
middle, or else by the device operation that ended it. Per-layer metric
readers take device time by kernel name from ``Trace.device_ms`` and
launch counts from ``Trace.count``."""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Tuple

import numpy as np

WINDOW = "shapbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    ops: List[Tuple[str, int, int]] = field(default_factory=list)   # device: name, start, end (ns)
    host: List[Tuple[str, int, int]] = field(default_factory=list)  # host ops
    window: Tuple[int, int] = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self, keys: Iterable[str]) -> List[Tuple[str, int, int]]:
        """Device operations whose lowercased name holds one of ``keys``."""
        keys = tuple(k.lower() for k in keys)
        return [op for op in self.ops if any(k in op[0].lower() for k in keys)]

    def device_ms(self, keys: Iterable[str]) -> float:
        return sum(e - s for _, s, e in self.kernels(keys)) / 1e6

    def count(self, keys: Iterable[str]) -> int:
        return len(self.kernels(keys))

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        w0, w1 = self.window
        spans = sorted((max(s, w0), min(e, w1)) for _, s, e in self.ops if e > w0 and s < w1)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The window's idle stretches: before, between and after the busy
        intervals."""
        w0, w1 = self.window
        out, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = e
        if w1 > t:
            out.append((t, w1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": the ``top`` device operations by total time,
        "idle_gaps": the ``top`` longest gaps by the host operation that
        ran at their middle}, seconds."""
        by_name: dict = {}
        for name, s, e in self.ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        starts = np.array([s for _, s, _ in self.host], dtype=np.int64)
        ends = np.array([e for _, _, e in self.host], dtype=np.int64)
        idle = []
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if hit.size:
                name = self.host[int(hit[np.argmin(ends[hit] - starts[hit])])][0]
            else:
                name = "host, before " + self._starting_at(g1)
            idle.append([name[:120], (g1 - g0) / 1e9])
        return {"device_ops": [[n, ns / 1e9] for n, ns in device_ops], "idle_gaps": idle}

    def _starting_at(self, t: int) -> str:
        names = [name for name, s, _ in self.ops if s == t]
        return names[0] if names else "the window's end"


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block (host and device) when ``enabled``; yields a
    holder whose ``trace`` is filled when the block ends."""
    holder = _Holder()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    import torch

    acts = [ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield holder
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    holder.trace = read_events(prof.profiler.kineto_results.events())
    print(f"shapbench: profiler stop {t1 - t0:.2f} s, read {time.perf_counter() - t1:.2f} s, "
          f"{len(holder.trace.ops)} device and {len(holder.trace.host)} host operations",
          file=sys.stderr)


class _Holder:
    trace: Optional[Trace] = None


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


def read_events(events) -> Trace:
    """Device operations, host operations and the window from kineto's
    events. Where the events carry no activity type (older builds), every
    device event but an annotation of the benchmark's own is an
    operation."""
    tr = Trace()
    for ev in events:
        kind = ev.activity_type() if hasattr(ev, "activity_type") else None
        name = ev.name()
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if str(ev.device_type()).endswith("CUDA"):
            if kind in DEVICE_KINDS or (kind is None and not name.startswith("shapbench.")):
                tr.ops.append((name, start, end))
        elif name == WINDOW:
            tr.window = (start, end)
        elif kind is None or kind in HOST_KINDS:
            tr.host.append((name, start, end))
    if tr.window == (0, 0):
        spans = tr.ops + tr.host
        if spans:
            tr.window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    return tr
