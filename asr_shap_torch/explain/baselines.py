"""Background (baseline) rows for the explainers.

* ``zeros_noise_background``: the pipeline's background, near-zero rows of
  sigma-scaled Gaussian noise.
* ``kmeans_background``: the equivalent of ``shap.kmeans(data, k)``,
  Lloyd's k-means returning the k centroids.
"""

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


def kmeans_background(data: torch.Tensor, k: int, init_idx: torch.Tensor,
                      num_iters: int = 25) -> torch.Tensor:
    """Summarize [M, N] background rows into k centroids: Lloyd's algorithm
    from the rows ``init_idx`` (k distinct indices, drawn by the caller),
    ``num_iters`` steps; a cluster that empties keeps its old centroid.
    Returns ``data`` itself when k >= M."""
    m = data.shape[0]
    if k >= m:
        return data
    c = data[init_idx.to(data.device)]
    for _ in range(num_iters):
        d = (data[:, None, :] - c[None, :, :]).square().sum(dim=-1)  # [M, k]
        onehot = torch.nn.functional.one_hot(d.argmin(dim=1), k).to(data.dtype)
        members = onehot.sum(dim=0)
        new_c = (onehot.T @ data) / members.clamp(min=1.0)[:, None]
        c = torch.where((members > 0)[:, None], new_c, c)
    return c
