"""Controlled test-set generation: clean clips plus seeded noise at fixed
SNRs, keeping the noise signal as the ground truth of the ITM.

Data sources, in order of preference:
  1. a caller-supplied iterable of (audio, text) pairs at the configured
     rate, or (audio, text, sample_rate) triples at any rate (resampled);
  2. the built-in text-conditional synthetic corpus: the utterance text
     determines the waveform, so a CTC model trained on it transcribes.

Randomness comes from ``core.prng`` streams over the reference's index
paths: utterance i of the synthetic provider from ``numpy_rng(seed,
1000 + i)``, the noise of clip ``count`` at SNR j from ``generator(seed,
count, j)``. The streams are not JAX's, so the audio differs from the
reference's test set; ``synthesize_text`` and ``synthetic_text`` under a
given ``np.random.Generator`` equal the reference's numpy mode bit for bit.
The dataset download of the reference (``load_librispeech_dummy``) is not
ported: with no source the synthetic provider runs, as in the reference
when the download fails.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from asr_shap_torch.audio.noise import (
    add_white_noise_at_snr,
    colored_noise,
    scale_noise_to_snr,
)
from asr_shap_torch.audio.resample import resample
from asr_shap_torch.core.config import TestSetConfig
from asr_shap_torch.core.prng import generator, numpy_rng


def synthetic_speech(gen: torch.Generator, n: int, sr: int = 16_000) -> np.ndarray:
    """Speech-like clip: voiced harmonic stacks with wandering f0, syllabic
    AM, ~30% silent 250 ms blocks (the first always voiced) and light
    aspiration noise, peak 0.5. Deterministic per generator state."""
    u1, u2 = torch.rand(2, generator=gen)
    t = torch.arange(n, dtype=torch.float32) / sr

    f0 = 110.0 + 40.0 * torch.sin(2 * np.pi * 0.7 * t + u1 * 6.28)
    phase = torch.cumsum(f0, dim=0) / sr
    voiced = sum((0.6 / h) * torch.sin(2 * np.pi * h * phase) for h in range(1, 6))

    env = torch.clamp(torch.sin(2 * np.pi * 3.7 * t + u2 * 6.28), min=0.0) ** 2

    n_blocks = n // (sr // 4) + 1
    gates = (torch.rand(n_blocks, generator=gen) > 0.3).to(torch.float32)
    gates[0] = 1.0
    gate = torch.repeat_interleave(gates, sr // 4)[:n]

    asp = 0.02 * torch.randn(n, generator=gen)
    sig = (voiced * env + asp) * gate
    sig = sig / (sig.abs().max() + 1e-9) * 0.5
    return sig.numpy().astype(np.float32)


def babble_noise(gen: torch.Generator, n: int, num_speakers: int = 6,
                 sr: int = 16_000) -> np.ndarray:
    """Speech-shaped noise: ``num_speakers`` synthetic-speech streams, each
    shifted by a seeded offset, overlapped and scaled to unit variance."""
    mix = np.zeros(n, np.float32)
    for _ in range(num_speakers):
        s = synthetic_speech(gen, n, sr)
        shift = int(torch.randint(0, max(1, n), (), generator=gen))
        mix += np.roll(s, shift)
    return mix / (mix.std() + 1e-12)


def make_noise_signal(gen: torch.Generator, n: int, kind: str) -> torch.Tensor:
    """Unit-scale noise of the family ``kind`` ("pink" or "babble"); the
    caller scales it to an SNR with ``scale_noise_to_snr``."""
    if kind == "pink":
        return colored_noise(gen, n, alpha=1.0)
    if kind == "babble":
        return torch.from_numpy(babble_noise(gen, n))
    raise ValueError(f"unknown noise kind {kind!r} (white|pink|babble)")


# Fixed word list for seeded text generation (uppercase, wav2vec2 vocab
# characters only; one apostrophe word exercises vocab id 27).
SYNTH_LEXICON: tuple = (
    "THE", "AND", "WATER", "STONE", "BLUE", "NORTH", "RIVER", "LIGHT",
    "SOUND", "GREEN", "HOUSE", "PAPER", "WIND", "GLASS", "FIELD", "CLOUD",
    "TRAIN", "VOICE", "NIGHT", "MORNING", "SILVER", "GARDEN", "WINTER",
    "SUMMER", "BIRD", "HORSE", "TABLE", "CHAIR", "SMALL", "LARGE", "QUICK",
    "ZEBRA", "JUMP", "FOX", "DON'T", "OVER", "UNDER", "SEVEN", "YELLOW",
    "PURPLE",
)

# samples per character at 16 kHz (100 ms, 5 encoder frames at x320)
CHAR_DURATION = 1_600

# characters with a synthesis pattern; a space is silence
_SYNTH_CHARS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ'"


def _char_table(sr: int):
    """Per-character fundamental (log scale over 150-620 Hz) and harmonic
    tilt, so each symbol has its own pitch and timbre."""
    idx = np.arange(len(_SYNTH_CHARS))
    f0 = 150.0 * (620.0 / 150.0) ** (idx / (len(_SYNTH_CHARS) - 1))
    tilt = 0.4 + 1.2 * ((idx * 7) % len(_SYNTH_CHARS)) / len(_SYNTH_CHARS)
    return f0, tilt


def synthesize_text(rng: np.random.Generator, text: str, sr: int = 16_000,
                    char_duration: int = CHAR_DURATION,
                    jitter: float = 0.02) -> np.ndarray:
    """Text -> waveform: each character a ``char_duration`` burst of 4
    harmonics (character-specific f0 and tilt, 10 ms attack and decay),
    spaces silent; ``rng`` adds a per-utterance pitch and amplitude jitter."""
    f0_table, tilt_table = _char_table(sr)
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
    f0 = np.where(voiced, f0_table[np.maximum(ids, 0)], 0.0) * pitch_jit  # [K]
    tilt = np.where(voiced, tilt_table[np.maximum(ids, 0)], 1.0)          # [K]
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
    """Seeded word sequence from the fixed lexicon."""
    idx = rng.integers(0, len(SYNTH_LEXICON), size=num_words)
    return " ".join(SYNTH_LEXICON[i] for i in idx)


def synthetic_utterance(rng: np.random.Generator, n_samples: int,
                        sr: int = 16_000) -> Tuple[np.ndarray, str]:
    """(audio, text) of >= ``n_samples`` samples: seeded text long enough to
    fill the window, synthesized, then zero-padded to length."""
    avg_chars = sum(len(w) for w in SYNTH_LEXICON) / len(SYNTH_LEXICON) + 1.0
    num_words = max(1, int(np.ceil(n_samples / CHAR_DURATION / avg_chars)) + 1)
    text = synthetic_text(rng, num_words)
    audio = synthesize_text(rng, text, sr)
    if len(audio) < n_samples:
        audio = np.pad(audio, (0, n_samples - len(audio)))
    return audio, text


def _synthetic_provider(cfg: TestSetConfig) -> Iterator[Tuple[np.ndarray, str]]:
    i = 0
    while True:
        # clips a bit over min_length, like a >= 100k-sample corpus filter
        n = cfg.min_length + (i % 4) * (cfg.sample_rate // 2)
        yield synthetic_utterance(numpy_rng(cfg.seed, 1000 + i), n)
        i += 1


def create_test_set(cfg: TestSetConfig = TestSetConfig(),
                    source: Optional[Iterable[tuple]] = None) -> List[Dict]:
    """The clean+noisy evaluation set. Per clip of >= ``cfg.min_length``
    samples (cut to ``cfg.max_length`` when set): one clean entry (snr=inf,
    noise zeros), then one noisy entry per SNR of ``cfg.snrs_db`` with the
    noise kept (noisy = clean + noise)."""
    if source is None:
        source = _synthetic_provider(cfg)

    test_set: List[Dict] = []
    count = 0
    for item in source:
        if count >= cfg.num_samples:
            break
        if len(item) == 3:
            audio, text, sr = item
            if int(sr) != cfg.sample_rate:
                audio = resample(torch.as_tensor(np.asarray(audio)), int(sr),
                                 cfg.sample_rate).numpy()
        else:
            audio, text = item
        if len(audio) < cfg.min_length:
            continue
        if cfg.max_length and len(audio) > cfg.max_length:
            audio = audio[: cfg.max_length]
        test_set.append({"type": "clean", "audio": audio, "text": text,
                         "snr": float("inf"), "noise": np.zeros_like(audio)})
        clean = torch.as_tensor(np.asarray(audio))
        for j, snr in enumerate(cfg.snrs_db):
            gen = generator(cfg.seed, count, j)
            if cfg.noise_kind == "white":
                noisy, noise = add_white_noise_at_snr(gen, clean, snr)
            else:
                raw = make_noise_signal(gen, len(audio), cfg.noise_kind)
                noisy, noise = scale_noise_to_snr(clean, raw, snr)
            test_set.append({"type": "noisy", "audio": noisy.numpy(), "text": text,
                             "snr": float(snr), "noise": noise.numpy()})
        count += 1
    return test_set
