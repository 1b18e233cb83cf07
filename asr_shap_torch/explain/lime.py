"""LIME for audio: a perturbation-based linear surrogate over waveform
segments.

The waveform is divided into S equal segments; M binary coalition masks
z ~ Bernoulli(keep_prob), the first the full coalition (the instance),
give masked inputs x_z = b + upsample(z) * (x - b) against a baseline b.
Each sample is weighted by the exponential kernel on its cosine distance to
the all-ones coalition, and each output's attribution is the weighted-ridge
coefficient of each segment (the intercept unpenalised), broadcast back to
the segment's samples: the [N, T_out] layout of the other explainers.

The masks come from a ``torch.Generator`` or are given explicitly
(``masks``); the coalitions are evaluated ``batch`` at a time, each batch
one batched model forward (``kernel_shap.masked_outputs``). The ridge
system is solved in float64 on the inputs' device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from asr_shap_torch.explain.kernel_shap import masked_outputs


class LimeExplanation(NamedTuple):
    values: torch.Tensor          # [N, T_out] per-sample attribution
    segment_values: torch.Tensor  # [S, T_out] per-segment coefficients
    intercept: torch.Tensor       # [T_out]
    model_output: torch.Tensor    # [T_out]


def lime_masks(generator: torch.Generator, num_segments: int, num_samples: int,
               keep_prob: float = 0.5) -> torch.Tensor:
    """[num_samples, S] float32 Bernoulli(keep_prob) masks on the
    generator's device, row 0 all ones."""
    u = torch.rand((num_samples, num_segments), generator=generator, device=generator.device)
    masks = (u < keep_prob).to(torch.float32)
    masks[0] = 1.0
    return masks


def lime_attributions(f_batch: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                      generator: Optional[torch.Generator] = None, num_segments: int = 64,
                      num_samples: int = 500, keep_prob: float = 0.5,
                      ridge_alpha: float = 1.0, kernel_width: float = 0.25,
                      baseline: Optional[torch.Tensor] = None, batch: int = 16,
                      masks: Optional[torch.Tensor] = None) -> LimeExplanation:
    """Explain f at x [N] with a LIME linear surrogate. ``f_batch`` maps a
    batch of waveforms [B, N] to outputs [B, T_out]. ``masks`` [M, S]
    replaces the generator's draws."""
    n = x.shape[0]
    if baseline is None:
        baseline = torch.zeros_like(x)
    if masks is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        masks = lime_masks(generator, num_segments, num_samples, keep_prob)
    if masks.shape[1] != num_segments:
        raise ValueError(f"masks of {masks.shape[1]} segments, {num_segments} expected")
    masks = masks.to(x.device, torch.float32)
    m = masks.shape[0]
    ys = masked_outputs(f_batch, x, baseline, masks, batch)      # [M, T_out]

    f64 = torch.float64
    z = masks.to(f64)
    # cosine distance to the all-ones coalition, exponential kernel
    cos = z.sum(dim=1) / (z.norm(dim=1) * num_segments ** 0.5 + 1e-12)
    w = torch.exp(-((1.0 - cos) ** 2) / kernel_width ** 2)     # [M]

    # weighted ridge with an unpenalised intercept: Z = [masks, 1]
    z = torch.cat([z, torch.ones((m, 1), dtype=f64, device=x.device)], dim=1)
    zw = z * w[:, None]
    a = z.T @ zw + ridge_alpha * torch.eye(num_segments + 1, dtype=f64, device=x.device)
    a[-1, -1] -= ridge_alpha
    beta = torch.linalg.solve(a, zw.T @ ys.to(f64)).to(torch.float32)  # [S+1, T_out]
    seg_vals, intercept = beta[:-1], beta[-1]
    values = seg_vals.repeat_interleave(-(-n // num_segments), dim=0)[:n]
    return LimeExplanation(values=values, segment_values=seg_vals, intercept=intercept,
                           model_output=ys[0])
