"""Model confidence = mean over frames of the max softmax probability."""

from __future__ import annotations

import torch


def mean_max_softmax_confidence(logits: torch.Tensor) -> torch.Tensor:
    """logits [..., T, V] -> one scalar per leading batch index."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return probs.amax(dim=-1).mean(dim=-1)
