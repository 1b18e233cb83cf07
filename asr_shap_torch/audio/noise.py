"""Controlled noise injection at a target SNR.

White noise mixed at a known SNR, with the noise signal kept as the ground
truth of the speech/noise dominance mask; colored (1/f^alpha) noise by
spectrum shaping; and the general rule that scales any noise to an SNR.
The draws come from an explicit ``torch.Generator`` (CPU), so a test set
is reproducible from its seed.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal float32 draws on the generator's device, moved to
    ``device``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def add_white_noise_at_snr(generator: torch.Generator, audio: torch.Tensor,
                           snr_db: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy_audio, noise) with white Gaussian noise at ``snr_db``:
    noise_power = signal_power / 10^(snr/10), noise ~ N(0, noise_power)."""
    audio = audio.to(torch.float32)
    noise_power = audio.square().mean() / (10.0 ** (snr_db / 10.0))
    noise = _randn(generator, audio.shape, audio.device) * noise_power.sqrt()
    return audio + noise, noise


def shape_spectrum(white: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Unit-variance noise with power spectral density proportional to
    1/f^alpha, by scaling the spectrum of the white noise ``white`` [n]
    (the DC bin is dropped)."""
    n = white.shape[-1]
    spec = torch.fft.rfft(white.to(torch.float32))
    f = torch.fft.rfftfreq(n, device=white.device)
    scale = torch.where(f > 0, torch.where(f > 0, f, 1.0) ** (-alpha / 2.0), 0.0)
    out = torch.fft.irfft(spec * scale, n).to(torch.float32)
    return out / (out.std(correction=0) + 1e-12)


def colored_noise(generator: torch.Generator, n: int, alpha: float = 1.0) -> torch.Tensor:
    """Unit-variance 1/f^alpha noise (alpha=1: pink, 2: brown) of length n."""
    return shape_spectrum(_randn(generator, (n,), generator.device), alpha)


def scale_noise_to_snr(audio: torch.Tensor, noise: torch.Tensor,
                       snr_db: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noisy_audio, scaled_noise): ``noise`` scaled so that the mix sits
    at ``snr_db``."""
    audio = audio.to(torch.float32)
    noise = noise.to(torch.float32)
    p_s = audio.square().mean(dim=-1, keepdim=True)
    p_n = noise.square().mean(dim=-1, keepdim=True).clamp(min=1e-12)
    scaled = noise * torch.sqrt(p_s / (p_n * (10.0 ** (snr_db / 10.0))))
    return audio + scaled, scaled


def mix_at_snr(speech: torch.Tensor, noise: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Mix any noise into speech at ``snr_db``: the noise is tiled or cut to
    the speech's length, then scaled by ``scale_noise_to_snr``."""
    speech = speech.to(torch.float32)
    noise = noise.to(torch.float32)
    n = speech.shape[-1]
    if noise.shape[-1] < n:
        noise = noise.repeat(*([1] * (noise.ndim - 1)), -(-n // noise.shape[-1]))
    mixed, _ = scale_noise_to_snr(speech, noise[..., :n], snr_db)
    return mixed
