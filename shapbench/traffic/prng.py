"""Deterministic streams from one run seed and an index path: a frozen copy
of ``asr_shap_torch/core/prng.py``. The reference derives the pipeline's
background rows and draws again through it: sample i of a run takes its
background from (seed, i, 0) and its draws from (seed, i, 1)."""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, *path: int) -> torch.Generator:
    """CPU ``torch.Generator`` for one (run seed, index path)."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2**63 - 1))


def numpy_rng(seed: int, *path: int) -> np.random.Generator:
    """``np.random.Generator`` for one (run seed, index path)."""
    return np.random.default_rng(np.random.SeedSequence([seed, *path]))


def seed64(seed: int, *path: int) -> int:
    """A 63-bit seed for a device ``torch.Generator`` from (seed, path)."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)
    return int(state[0]) & (2**63 - 1)
