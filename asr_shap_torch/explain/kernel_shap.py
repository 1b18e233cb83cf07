"""KernelSHAP for audio: model-agnostic Shapley values of waveform segments.

The waveform is divided into S equal segments; a coalition z in {0,1}^S
gives the masked input x_z = b + upsample(z) * (x - b) against a baseline
b. The Shapley-kernel weighted least-squares fit of
y(z) ~ phi_0 + sum_i phi_i z_i gives the Shapley values of the segment
game; the constraints phi_0 = f(b) and sum_i phi_i = f(x) - f(b) are
imposed by substitution, so efficiency holds exactly.

Two regimes:
  * ``enumerate_all=True`` (S <= 16): all 2^S - 2 proper coalitions with
    their analytic kernel weights, exact Shapley values of the segment game;
  * sampled: coalition sizes s with p(s) ∝ 1/(s(S-s)), members uniform
    within a size, each row paired with its complement; drawn ∝ their
    kernel weight, so the regression is unweighted.

Torch cannot reproduce the reference's threefry draws, so the coalitions
come from a ``torch.Generator`` or are given explicitly (``masks``), as
``expected_gradients`` takes explicit draws. The coalitions are evaluated
``batch`` at a time, each batch one batched model forward. The regression
(S x S normal equations) is solved in float64 on the inputs' device.
Returns the [N, T_out] layout of the other explainers: each segment's value
broadcast to its samples.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["KernelShapExplanation", "kernel_shap_attributions", "sample_coalitions"]


class KernelShapExplanation(NamedTuple):
    values: torch.Tensor          # [N, T_out] per-sample attribution
    segment_values: torch.Tensor  # [S, T_out] per-segment Shapley values
    base_value: torch.Tensor      # [T_out] f(baseline) (phi_0)
    model_output: torch.Tensor    # [T_out] f(x)


def _all_coalitions(num_segments: int) -> tuple[np.ndarray, np.ndarray]:
    """All proper coalitions (sizes 1..S-1), 2^S - 2 rows, and their
    Shapley-kernel weights (S-1) / (C(S,|z|) |z| (S-|z|))."""
    s = num_segments
    codes = np.arange(1, 2**s - 1, dtype=np.uint64)
    masks = ((codes[:, None] >> np.arange(s, dtype=np.uint64)) & 1).astype(np.float32)
    sizes = masks.sum(axis=1).astype(np.int64)
    comb = np.array([math.comb(s, k) for k in range(s + 1)], np.float64)
    w = (s - 1.0) / (comb[sizes] * sizes * (s - sizes))
    return masks, w.astype(np.float32)


def sample_coalitions(generator: torch.Generator, num_segments: int,
                      num_samples: int) -> torch.Tensor:
    """[num_samples, S] float32 coalitions on the generator's device: sizes
    from p(s) ∝ 1/(s(S-s)), members uniform within a size, the first half
    followed by its complements; an odd count repeats the first row."""
    s, half = num_segments, num_samples // 2
    dev = generator.device
    support = torch.arange(1, s, dtype=torch.float64, device=dev)
    sizes = 1 + torch.multinomial(1.0 / (support * (s - support)), half, replacement=True,
                                  generator=generator)
    u = torch.rand((half, s), generator=generator, device=dev)
    ranks = u.argsort(dim=1).argsort(dim=1)                     # a permutation of 0..S-1
    masks = (ranks < sizes[:, None]).to(torch.float32)
    paired = torch.cat([masks, 1.0 - masks])
    if paired.shape[0] < num_samples:
        paired = torch.cat([paired, paired[:1]])
    return paired


def upsample(z: torch.Tensor, n: int) -> torch.Tensor:
    """Segment masks [M, S] -> sample masks [M, n], segments of ceil(n / S)."""
    return z.repeat_interleave(-(-n // z.shape[1]), dim=1)[:, :n]


def masked_outputs(f_batch: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                   baseline: torch.Tensor, masks: torch.Tensor, batch: int) -> torch.Tensor:
    """f at b + upsample(z) * (x - b) for each row z of ``masks``, ``batch``
    rows per call of ``f_batch`` ([B, N] -> [B, T_out]). [M, T_out]."""
    n = x.shape[0]
    delta = x - baseline
    with torch.no_grad():
        return torch.cat([f_batch(baseline + upsample(masks[i:i + batch], n) * delta)
                          for i in range(0, masks.shape[0], batch)])


def kernel_shap_attributions(f_batch: Callable[[torch.Tensor], torch.Tensor],
                             x: torch.Tensor, generator: Optional[torch.Generator] = None,
                             num_segments: int = 32, num_samples: int = 512,
                             baseline: Optional[torch.Tensor] = None, batch: int = 16,
                             ridge_alpha: float = 1e-6, enumerate_all: bool = False,
                             masks: Optional[torch.Tensor] = None) -> KernelShapExplanation:
    """Explain f at x [N] with segment-level KernelSHAP. ``f_batch`` maps a
    batch of waveforms [B, N] to outputs [B, T_out]. The coalitions are all
    of them (``enumerate_all``), ``masks`` [M, S] if given, else
    ``num_samples`` drawn from ``generator``."""
    n, s = x.shape[0], num_segments
    if baseline is None:
        baseline = torch.zeros_like(x)
    if enumerate_all:
        if s > 16:
            raise ValueError(f"enumerate_all builds 2^{s}-2 coalitions; use sampled mode "
                             "for num_segments > 16")
        masks_np, w_np = _all_coalitions(s)
        masks, w = torch.from_numpy(masks_np), torch.from_numpy(w_np)
    else:
        if masks is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            masks = sample_coalitions(generator, s, num_samples)
        w = torch.ones(masks.shape[0])  # drawn ∝ the kernel: unweighted
    if masks.shape[1] != s:
        raise ValueError(f"coalitions of {masks.shape[1]} segments, {s} expected")
    masks, w = masks.to(x.device, torch.float32), w.to(x.device)

    with torch.no_grad():
        fx, fb = f_batch(torch.stack([x, baseline]))
    ys = masked_outputs(f_batch, x, baseline, masks, batch)      # [M, T_out]

    # phi_S = delta - sum_{i<S} phi_i:
    #   y - f(b) - z_S * delta  ~  sum_{i<S} phi_i (z_i - z_S)
    f64 = torch.float64
    delta = (fx - fb).to(f64)
    z_last = masks[:, -1:].to(f64)
    feats = masks[:, :-1].to(f64) - z_last                     # [M, S-1]
    targ = ys.to(f64) - fb.to(f64)[None, :] - z_last * delta[None, :]
    fw = feats * w.to(f64)[:, None]
    a = feats.T @ fw + ridge_alpha * torch.eye(s - 1, dtype=f64, device=x.device)
    phi_head = torch.linalg.solve(a, fw.T @ targ)              # [S-1, T_out]
    phi_last = delta[None, :] - phi_head.sum(dim=0, keepdim=True)
    seg_vals = torch.cat([phi_head, phi_last]).to(torch.float32)  # [S, T_out]
    values = seg_vals.repeat_interleave(-(-n // s), dim=0)[:n]
    return KernelShapExplanation(values=values, segment_values=seg_vals, base_value=fb,
                                 model_output=fx)
