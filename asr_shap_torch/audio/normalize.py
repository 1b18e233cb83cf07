"""Waveform normalization: per-utterance zero mean and unit variance, with
the biased variance and eps = 1e-7 inside the square root (the Wav2Vec2
feature extractor's contract)."""

from __future__ import annotations

import torch

_EPS = 1e-7


def zero_mean_unit_var(x: torch.Tensor,
                       lengths: torch.Tensor | None = None) -> torch.Tensor:
    """x: [..., N]. With ``lengths`` (shape [...]) the statistics cover only
    the first ``lengths`` samples of each row and padding is zeroed."""
    x = x.to(torch.float32)
    if lengths is None:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + _EPS)

    idx = torch.arange(x.shape[-1], device=x.device)
    mask = (idx < lengths.to(x.device)[..., None]).to(torch.float32)
    cnt = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
    mean = (x * mask).sum(dim=-1, keepdim=True) / cnt
    var = ((x - mean).square() * mask).sum(dim=-1, keepdim=True) / cnt
    return (x - mean) / torch.sqrt(var + _EPS) * mask
