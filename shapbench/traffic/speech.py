"""Text-conditional synthetic speech: a frozen copy of the synthetic corpus
of ``asr_shap_torch/pipeline/testset.py`` (``synthesize_text``,
``synthetic_text``, ``synthetic_utterance``). The utterance text determines
the waveform: each character a 100 ms burst of four harmonics with its own
pitch and tilt, spaces silent."""

from __future__ import annotations

from typing import Tuple

import numpy as np

SYNTH_LEXICON: tuple = (
    "THE", "AND", "WATER", "STONE", "BLUE", "NORTH", "RIVER", "LIGHT",
    "SOUND", "GREEN", "HOUSE", "PAPER", "WIND", "GLASS", "FIELD", "CLOUD",
    "TRAIN", "VOICE", "NIGHT", "MORNING", "SILVER", "GARDEN", "WINTER",
    "SUMMER", "BIRD", "HORSE", "TABLE", "CHAIR", "SMALL", "LARGE", "QUICK",
    "ZEBRA", "JUMP", "FOX", "DON'T", "OVER", "UNDER", "SEVEN", "YELLOW",
    "PURPLE",
)
CHAR_DURATION = 1_600  # samples per character at 16 kHz
_SYNTH_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ'"


def _char_table():
    idx = np.arange(len(_SYNTH_CHARS))
    f0 = 150.0 * (620.0 / 150.0) ** (idx / (len(_SYNTH_CHARS) - 1))
    tilt = 0.4 + 1.2 * ((idx * 7) % len(_SYNTH_CHARS)) / len(_SYNTH_CHARS)
    return f0, tilt


def synthesize_text(rng: np.random.Generator, text: str, sr: int = 16_000,
                    char_duration: int = CHAR_DURATION,
                    jitter: float = 0.02) -> np.ndarray:
    """Text -> waveform, peak 0.5 times a per-utterance amplitude jitter."""
    f0_table, tilt_table = _char_table()
    char_to_idx = {c: i for i, c in enumerate(_SYNTH_CHARS)}
    ids = np.array([char_to_idx.get(c, -1) for c in text.upper()], np.int32)
    pitch_jit = 1.0 + jitter * float(rng.standard_normal())
    amp_jit = 0.85 + 0.15 * float(rng.random())

    t = np.arange(char_duration) / sr
    ramp = int(0.010 * sr)
    env = np.ones(char_duration, np.float32)
    win = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
    env[:ramp] = win
    env[-ramp:] = win[::-1]

    voiced = ids >= 0
    f0 = np.where(voiced, f0_table[np.maximum(ids, 0)], 0.0) * pitch_jit
    tilt = np.where(voiced, tilt_table[np.maximum(ids, 0)], 1.0)
    seg = np.zeros((len(ids), char_duration), np.float32)
    for h in range(1, 5):
        w = (1.0 / h ** tilt)[:, None]
        seg += (w * np.sin(2 * np.pi * h * f0[:, None] * t[None, :])).astype(np.float32)
    seg *= env[None, :] * voiced[:, None].astype(np.float32)
    sig = seg.reshape(-1)
    peak = np.abs(sig).max()
    if peak > 0:
        sig = sig / peak * 0.5 * amp_jit
    return sig.astype(np.float32)


def synthetic_text(rng: np.random.Generator, num_words: int) -> str:
    idx = rng.integers(0, len(SYNTH_LEXICON), size=num_words)
    return " ".join(SYNTH_LEXICON[i] for i in idx)


def synthetic_utterance(rng: np.random.Generator, n_samples: int,
                        sr: int = 16_000) -> Tuple[np.ndarray, str]:
    """(audio, text) of at least ``n_samples`` samples: text long enough to
    fill them, synthesized, zero-padded to length."""
    avg_chars = sum(len(w) for w in SYNTH_LEXICON) / len(SYNTH_LEXICON) + 1.0
    num_words = max(1, int(np.ceil(n_samples / CHAR_DURATION / avg_chars)) + 1)
    text = synthetic_text(rng, num_words)
    audio = synthesize_text(rng, text, sr)
    if len(audio) < n_samples:
        audio = np.pad(audio, (0, n_samples - len(audio)))
    return audio, text
