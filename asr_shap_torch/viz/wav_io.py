"""Mono 16-bit PCM WAV files through the stdlib ``wave`` module."""

from __future__ import annotations

import wave

import numpy as np


def write_wav(path: str, audio: np.ndarray, sr: int = 16_000) -> None:
    """Write mono float waveform (clipped to [-1, 1]) as 16-bit PCM."""
    audio = np.asarray(audio, dtype=np.float64)
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> tuple[np.ndarray, int]:
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        data = np.frombuffer(w.readframes(n), dtype="<i2")
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    return data.astype(np.float32) / 32767.0, sr
