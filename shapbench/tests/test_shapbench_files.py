"""Every configuration, cell and per-layer metric file parses and resolves
by name, BENCHMARK.json names only what exists, and a new cell file is
found with no edit to any file."""

import json
import re
import shutil
from pathlib import Path

import pytest

from shapbench import registry
from shapbench.window import load_metric, metric_files

REPO = registry.ROOT.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cell_names():
    return sorted(p.stem for p in (registry.ROOT / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", cell_names())
def test_cell_resolves(name):
    wl, cfg, fam = registry.cell(name)
    assert wl["t_out"] == fam.frames(cfg["arch"], wl["clips"]["samples"]) > 0
    assert NAME.match(name) and len(wl["why"]) <= 200 and "\n" not in wl["why"]
    assert wl["check"]["limits"] and wl["chips"] in (1, 4)
    assert set(wl["explainer"]) <= {"method", "aggregation", "num_background",
                                    "background_sigma", "nsamples", "draw_chunk",
                                    "output_chunk", "remat", "host_draw_chunk"}


@pytest.mark.parametrize("name", sorted(p.stem for p in (registry.ROOT / "configs").glob("*.json")))
def test_config_resolves(name):
    cfg = registry.load_json("configs", name)
    fam = registry.family(cfg["family"])
    assert cfg["source"].startswith("https://")
    assert fam.param_specs(cfg["arch"])


@pytest.mark.parametrize("name", sorted(metric_files()))
def test_metric_resolves(name):
    mod = load_metric(metric_files()[name])
    assert UNIT.match(mod.UNIT) and callable(mod.read)


def test_benchmark_json_names_what_exists():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("shapbench/")
        assert Path(c["file"]).stem == c["name"]
    for w in b["workloads"]:
        wl = registry.load_json("workloads", w["name"])
        assert w["config"] == wl["config"] and w["config"] in configs
        assert w["traffic"] == wl["traffic"] and w["chips"] == wl["chips"]
        assert w["why"] == wl["why"]
    metrics = metric_files()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["name"] in metrics and m["moves"] in e2e
        assert load_metric(metrics[m["name"]]).UNIT == m["unit"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    assert {(w["config"], w["traffic"]) for w in b["workloads"]}.__len__() == len(b["workloads"])


def test_a_new_cell_file_is_found_without_edits(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(registry.ROOT / "configs", root / "configs")
    shutil.copytree(registry.ROOT / "workloads", root / "workloads")
    before = {p: p.read_bytes() for p in root.rglob("*.json")}
    wl = registry.load_json("workloads", "eg-w2v2-base-f32-3s")
    wl["clips"]["samples"] = 64000
    (root / "workloads" / "eg-w2v2-base-f32-4s.json").write_text(json.dumps(wl))
    new, cfg, fam = registry.cell("eg-w2v2-base-f32-4s", root)
    assert new["t_out"] == 199
    assert all(p.read_bytes() == b for p, b in before.items())
    with pytest.raises(KeyError):
        registry.cell("no-such-cell", root)
