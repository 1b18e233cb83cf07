"""Background (baseline) rows for the explainers."""

from __future__ import annotations

import torch

from asr_shap_torch.core.device import resolve_device


def zeros_noise_background(generator: torch.Generator, n_input: int,
                           num_background: int = 5, sigma: float = 0.01,
                           device: str | torch.device = "cuda") -> torch.Tensor:
    """[num_background, n_input] near-zero rows: sigma * N(0, 1), drawn on
    the generator's device and moved to ``device``."""
    rows = torch.randn((num_background, n_input), generator=generator,
                       dtype=torch.float32, device=generator.device)
    return (sigma * rows).to(resolve_device(device))
