"""The one traffic generator: the clips of a cell from its ``clips``
parameters and the run seed.

Clip k is a fresh synthetic utterance from stream (seed, 1000 + k), cut to
exactly ``samples`` samples (every clip is one length bucket), mixed with
white noise from stream (seed, 2000, k) at ``snr_cycle_db[k % len]`` dB (None:
clean, noise zeros). Every seed gives the same lengths and the same cycle
of SNRs; only the content differs. ``first`` offsets k, so the warm-up
clip is not one of the window's. The pipeline draws sample i's background
and draws from (seed, i, 0) and (seed, i, 1), which these paths avoid."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from shapbench.traffic.noise import add_white_noise_at_snr
from shapbench.traffic.prng import generator, numpy_rng
from shapbench.traffic.speech import synthetic_utterance

WARMUP_FIRST = 1_000_000  # clip index of the warm-up call's clip


def make_clips(params: Dict, seed: int, count: int, first: int = 0) -> List[Dict]:
    """``count`` clip dicts ("audio", "noise", "text", "type", "snr") as
    ``run_shap_pipeline`` takes them."""
    n = int(params["samples"])
    cycle = params["snr_cycle_db"]
    clips = []
    for k in range(first, first + count):
        audio, text = synthetic_utterance(numpy_rng(seed, 1000 + k), n)
        audio = audio[:n]
        snr = cycle[k % len(cycle)]
        if snr is None:
            clips.append({"type": "clean", "audio": audio, "text": text,
                          "snr": float("inf"), "noise": np.zeros_like(audio)})
            continue
        noisy, noise = add_white_noise_at_snr(generator(seed, 2000, k),
                                              torch.from_numpy(audio), float(snr))
        clips.append({"type": "noisy", "audio": noisy.numpy(), "text": text,
                      "snr": float(snr), "noise": noise.numpy()})
    return clips
