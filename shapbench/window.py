"""What a per-layer metric reader is given: the cell, its shapes, the
timed call's results and host clock, the port's launch counters over the
call, and the trace (``None`` in an untraced run)."""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from shapbench.trace import Trace

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclass
class Window:
    workload: Dict          # the cell's file, with "t_out" added
    arch: Dict              # the configuration's "arch"
    family: object          # the configuration's reference module
    results: List[Dict]     # the call's per-clip result dicts
    window_s: float         # the call's wall, host clock
    launches: Dict[str, int] = field(default_factory=dict)
    trace: Optional[Trace] = None

    @property
    def clips(self) -> int:
        return len(self.results)

    @property
    def draws(self) -> int:
        from shapbench.costs import draws_per_clip

        return self.clips * draws_per_clip(self.workload)

    @property
    def dtype(self) -> str:
        return self.workload["numerics"]["dtype"]


def load_metric(path: Path):
    """A per-layer metric's module: ``UNIT`` and ``read(window) -> float |
    None`` (None: nothing to read; the metric is left out of the line)."""
    spec = importlib.util.spec_from_file_location(f"shapbench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_files(directory: Path = METRICS_DIR) -> Dict[str, Path]:
    """{metric name: file}: every ``<name>.py`` of the metrics directory."""
    return {p.name[:-3]: p for p in sorted(directory.glob("*.py")) if p.name != "__init__.py"}


def read_metrics(w: Window, directory: Path = METRICS_DIR) -> Dict[str, Dict]:
    """Every per-layer metric that finds something to read, as result-line
    entries."""
    out = {}
    for name, path in metric_files(directory).items():
        mod = load_metric(path)
        value = mod.read(w)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out
