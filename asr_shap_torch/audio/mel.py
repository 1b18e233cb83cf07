"""STFT and mel spectrogram front end, on the input's device.

Framing with reflect padding under ``center``, a periodic Hann (or
rectangular) window, ``torch.fft.rfft`` over the frames, then a mel
filterbank product. Both mel conventions are supported: "slaney" (librosa's
default) and "htk" (torchaudio's). The filterbank is host numpy, cached,
and moved to the input's device per call.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _hz_to_mel(f, scale: str):
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    # slaney: linear below 1 kHz, log above
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)
    return np.where(
        f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mels
    )


def _mel_to_hz(m, scale: str):
    if scale == "htk":
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=32)
def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    scale: str = "slaney",
    norm: str | None = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_fft//2 + 1, n_mels] (host numpy,
    float32, cached)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)

    fb = np.zeros((n_fft // 2 + 1, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[np.newaxis, :]
    return fb.astype(np.float32)


def hann_window(n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window of librosa and torchaudio, float32."""
    n = torch.arange(n_fft, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, center: bool) -> torch.Tensor:
    """[..., N] -> [..., n_frames, n_fft] frames."""
    if center:
        lead = x.shape[:-1]
        x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                                    mode="reflect").reshape(*lead, -1)
    return x.unfold(-1, n_fft, hop)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 512,
    window: str = "hann",
    center: bool = True,
    power: float = 2.0,
) -> torch.Tensor:
    """Power (or magnitude) spectrogram, [..., n_frames, n_fft//2+1]."""
    x = torch.as_tensor(x)
    if window == "hann":
        win = hann_window(n_fft, x.device)
    elif window == "ones":
        win = torch.ones((n_fft,), dtype=torch.float32, device=x.device)
    else:
        raise ValueError(f"unknown window {window}")
    frames = frame_signal(x.to(torch.float32), n_fft, hop_length, center)
    mag = torch.fft.rfft(frames * win, dim=-1).abs()
    if power == 1.0:
        return mag
    return mag**power


def log_mel_spectrogram(
    x: torch.Tensor,
    sr: int = 16_000,
    n_fft: int = 1024,
    hop_length: int = 512,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = None,
    scale: str = "slaney",
    norm: str | None = "slaney",
    log: str = "db",
    top_db: float | None = 80.0,
) -> torch.Tensor:
    """Log-mel spectrogram, [..., n_frames, n_mels].

    log="db" is librosa's power_to_db(ref=max), the reference over the last
    two axes and clipped ``top_db`` below it; log="natural" is ln(mel +
    1e-10); log="none" returns the mel power."""
    power = stft_magnitude(x, n_fft, hop_length, center=True, power=2.0)
    fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax, scale, norm))
    mel = power @ fb.to(power.device)
    if log == "none":
        return mel
    if log == "natural":
        return torch.log(mel + 1e-10)
    db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    db = db - db.amax(dim=(-2, -1), keepdim=True)
    if top_db is not None:
        db = torch.clamp(db, min=-top_db)
    return db
