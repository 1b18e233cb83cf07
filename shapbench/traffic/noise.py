"""White noise mixed at a target SNR, the noise kept as ground truth: a
frozen copy of ``asr_shap_torch/audio/noise.py::add_white_noise_at_snr``."""

from __future__ import annotations

from typing import Tuple

import torch


def add_white_noise_at_snr(generator: torch.Generator, audio: torch.Tensor,
                           snr_db: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy_audio, noise): noise_power = signal_power / 10^(snr/10),
    noise ~ N(0, noise_power), drawn on the generator's device."""
    audio = audio.to(torch.float32)
    noise_power = audio.square().mean() / (10.0 ** (snr_db / 10.0))
    noise = torch.randn(audio.shape, generator=generator, dtype=torch.float32,
                        device=generator.device).to(audio.device) * noise_power.sqrt()
    return audio + noise, noise
