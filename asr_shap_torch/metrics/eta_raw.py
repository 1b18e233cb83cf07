"""eta_raw, the Raw Audio Speech Relevance Score.

Split the clean and noise signals into segments of ``segment_ms``; a
segment is speech-dominated when its clean energy exceeds the noise energy
("strict") or half of it ("half"), the Ideal Time-domain Mask. Segment
relevance is the segment mean of the per-sample total attribution
sum_t |phi[n, t]|; tau is its ``percentile``-th percentile (linear
interpolation); eta_raw is the share of segments with relevance >= tau that
are speech-dominated. The ``>=`` keeps tied top blocks: with a strict ``>``
a tie spanning the top percent would select nothing.

Every result, the degenerate zeros included, is a float32 scalar on the
input's device. No branch depends on the data (only on shapes), so the
function is the same under ``torch.vmap`` as in a loop.
"""

from __future__ import annotations

import torch

from asr_shap_torch.core.config import MetricConfig


def eta_raw(clean_audio: torch.Tensor, noise_audio: torch.Tensor,
            shap_matrix: torch.Tensor,
            config: MetricConfig = MetricConfig()) -> torch.Tensor:
    """eta_raw for one sample. shap_matrix [N_audio, T_frames], a transposed
    [T_frames, N_audio], or an already reduced [N_audio]."""
    seg = int(config.sample_rate * (config.segment_ms / 1000.0))
    if seg == 0:
        raise ValueError("segment_ms too small: 0 samples per segment")

    if shap_matrix.ndim == 1:
        phi_total = shap_matrix.abs()
    else:
        if (shap_matrix.shape[0] != clean_audio.shape[0]
                and shap_matrix.shape[1] == clean_audio.shape[0]):
            shap_matrix = shap_matrix.T
        phi_total = shap_matrix.abs().sum(dim=-1)

    min_len = min(clean_audio.shape[0], noise_audio.shape[0], phi_total.shape[0])
    num_segments = min_len // seg
    if num_segments == 0:
        return torch.zeros((), dtype=torch.float32, device=shap_matrix.device)
    trunc = num_segments * seg

    clean_seg = clean_audio[:trunc].reshape(num_segments, seg).to(torch.float32)
    noise_seg = noise_audio[:trunc].reshape(num_segments, seg).to(torch.float32)
    e_c = clean_seg.square().sum(dim=1)
    e_u = noise_seg.square().sum(dim=1)
    if config.itm_variant == "half":
        itm = e_c > 0.5 * e_u
    elif config.itm_variant == "strict":
        itm = e_c > e_u
    else:
        raise ValueError(f"unknown itm_variant {config.itm_variant!r}")

    bar_phi = phi_total[:trunc].reshape(num_segments, seg).to(torch.float32).mean(dim=1)
    tau = torch.quantile(bar_phi, config.percentile / 100.0, interpolation="linear")
    relevant = bar_phi >= tau
    denom = relevant.sum()
    num = (relevant & itm.to(relevant.device)).sum()
    return torch.where(denom == 0, 0.0,
                       num.to(torch.float32) / denom.clamp(min=1).to(torch.float32))
