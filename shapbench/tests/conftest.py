"""Shared fixtures of the benchmark's CPU tests: tiny copies of the real
configurations and cells (narrow widths, short clips, few draws), with the
real cells' limits and controls."""

import json
from pathlib import Path

import pytest
import torch

from shapbench import registry

TINY_ARCH = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                 intermediate_size=128, conv_dim=[128, 128, 128], conv_stride=[5, 2, 2],
                 conv_kernel=[10, 3, 2], feat_proj_dim=128, num_conv_pos_embeddings=16,
                 num_conv_pos_embedding_groups=4)
TINY_CELLS = {  # tiny cell: (real cell, tiny config)
    "tiny-base": ("eg-w2v2-base-f32-3s", "tiny-base"),
    "tiny-conformer": ("eg-w2v2-conformer-f32-3s", "tiny-conformer"),
    "tiny-bf16": ("eg-w2v2-base-bf16-3s", "tiny-base"),
}
REAL_CONFIGS = {"tiny-base": "wav2vec2-base-960h",
                "tiny-conformer": "wav2vec2-conformer-rel-pos-large-960h-ft"}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A registry root with the tiny configurations and cells."""
    root = tmp_path_factory.mktemp("shapbench_root")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for name, real in REAL_CONFIGS.items():
        cfg = registry.load_json("configs", real)
        cfg["arch"].update(TINY_ARCH)
        if "conv_depthwise_kernel_size" in cfg["arch"]:
            cfg["arch"]["conv_depthwise_kernel_size"] = 7
        (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, (real, cfg_name) in TINY_CELLS.items():
        wl = registry.load_json("workloads", real)
        wl["config"] = cfg_name
        wl["clips"]["samples"] = 1600
        wl["explainer"].update(nsamples=4, draw_chunk=2, output_chunk=3)
        (root / "workloads" / f"{name}.json").write_text(json.dumps(wl))
    return root


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
