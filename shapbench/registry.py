"""Files by name: a configuration is ``configs/<name>.json`` with its
reference ``reference/<family>.py``; a cell is ``workloads/<name>.json``;
a per-layer metric is ``metrics/<name>.py`` (``window.py``). Adding any of
them adds files and edits none."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, Tuple

ROOT = Path(__file__).resolve().parent


def load_json(kind: str, name: str, root: Path = ROOT) -> Dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (root / kind).glob("*.json"))
        raise KeyError(f"no {kind[:-1]} {name!r} under {root / kind} (known: {known})")
    with open(path) as f:
        return json.load(f)


def family(name: str):
    """The reference module of a model family."""
    return importlib.import_module(f"shapbench.reference.{name}")


def cell(name: str, root: Path = ROOT) -> Tuple[Dict, Dict, object]:
    """(the cell's file with "t_out" added, its configuration's file, the
    configuration's reference module)."""
    wl = load_json("workloads", name, root)
    cfg = load_json("configs", wl["config"], root)
    fam = family(cfg["family"])
    wl = dict(wl, t_out=fam.frames(cfg["arch"], wl["clips"]["samples"]))
    return wl, cfg, fam
