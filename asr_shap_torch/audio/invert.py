"""Spectrogram inversion: Griffin-Lim on the magnitude's device.

The capability of librosa's ``mel_to_audio``, used by the hover-to-play
scrubber (``viz/scrubber.py``): ``n_iter`` STFT/iSTFT round trips from a
zero initial phase (deterministic), with Hann overlap-add through
``index_add_``; the mel-to-linear lift uses the filterbank's
pseudo-inverse, computed once on the host and cached.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from asr_shap_torch.audio.mel import frame_signal, hann_window, mel_filterbank


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, length: int) -> torch.Tensor:
    """Inverse STFT with Hann-window overlap-add. spec: [frames, n_fft//2+1]
    complex (centered framing). Returns [length]."""
    win = hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win  # [T, n_fft]
    t = frames.shape[0]
    total = n_fft + hop_length * (t - 1)
    idx = (torch.arange(t, device=spec.device)[:, None] * hop_length
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    sig = torch.zeros((total,), dtype=frames.dtype, device=spec.device)
    sig.index_add_(0, idx, frames.reshape(-1))
    norm = torch.zeros((total,), dtype=frames.dtype, device=spec.device)
    norm.index_add_(0, idx, (win**2).expand(t, n_fft).reshape(-1))
    sig = sig / torch.clamp(norm, min=1e-8)
    # undo the center padding; a window past the end is moved back inside,
    # as the reference's dynamic_slice moves it
    start = max(0, min(n_fft // 2, total - length))
    return sig[start:start + length]


def _stft_complex(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    frames = frame_signal(x, n_fft, hop, center=True)
    return torch.fft.rfft(frames * hann_window(n_fft, x.device), dim=-1)


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 512,
    length: int | None = None,
    n_iter: int = 32,
) -> torch.Tensor:
    """Phase retrieval from an STFT magnitude [frames, n_fft//2+1]."""
    t = magnitude.shape[0]
    if length is None:
        length = hop_length * (t - 1)
    spec = magnitude.to(torch.complex64)  # zero initial phase (deterministic)
    for _ in range(n_iter):
        x = istft(spec, n_fft, hop_length, length)
        rebuilt = _stft_complex(x, n_fft, hop_length)[:t]
        spec = magnitude * (rebuilt / torch.clamp(rebuilt.abs(), min=1e-10))
    return istft(spec, n_fft, hop_length, length)


@functools.lru_cache(maxsize=8)
def _mel_pinv(sr, n_fft, n_mels, scale, norm) -> np.ndarray:
    fb = mel_filterbank(sr, n_fft, n_mels, scale=scale, norm=norm)  # [F, M]
    return np.linalg.pinv(fb).astype(np.float32)  # [M, F]


def mel_to_audio(
    mel_power: torch.Tensor,
    sr: int = 16_000,
    n_fft: int = 1024,
    hop_length: int = 512,
    length: int | None = None,
    n_iter: int = 32,
    scale: str = "slaney",
    norm: str | None = "slaney",
) -> torch.Tensor:
    """Mel power spectrogram [frames, n_mels] -> waveform (librosa
    mel_to_audio capability)."""
    n_mels = mel_power.shape[-1]
    pinv = torch.from_numpy(_mel_pinv(sr, n_fft, n_mels, scale, norm)).to(mel_power.device)
    power = torch.clamp(mel_power @ pinv, min=0.0)  # [frames, F]
    return griffin_lim(torch.sqrt(power), n_fft, hop_length, length, n_iter)
