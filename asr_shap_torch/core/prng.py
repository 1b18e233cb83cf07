"""Deterministic random streams, derived from one run seed.

The reference package folds integer paths into a JAX key
(``fold(key, *indices)``). Torch cannot reproduce JAX's threefry draws, so
the port derives its streams from ``np.random.SeedSequence`` over the same
paths instead: ``generator(seed, *path)`` for torch draws and
``numpy_rng(seed, *path)`` for numpy draws. The same (seed, path) always
gives the same stream, and different paths give independent streams; the
values differ from the reference's.
"""

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
