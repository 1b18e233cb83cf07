"""Sample-rate conversion: a polyphase windowed-sinc resampler as one
strided convolution.

The rate pair reduces by its gcd to ``up = new/g`` and ``down = orig/g``. A
bank of ``up`` FIR phases of a Hann-windowed sinc low-pass (cut at
``rolloff`` times the smaller Nyquist) runs as one ``F.conv1d`` with stride
``down`` and ``up`` output channels, which interleave into time. The bank
and the padding (``width`` before, ``width + down`` after) are the
reference package's, so both give the same output to float32 rounding.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _kernel_bank(orig_freq: int, new_freq: int, lowpass_filter_width: int,
                 rolloff: float) -> tuple[np.ndarray, int, int, int]:
    """(bank [up, K], pad width, up, down) for one rate pair, K = 2 * width
    + down. Phase i evaluates the windowed sinc at output time i/up against
    the input grid j/down (reduced-rate units)."""
    g = math.gcd(int(orig_freq), int(new_freq))
    down = int(orig_freq) // g
    up = int(new_freq) // g

    base_freq = min(down, up) * rolloff
    width = int(math.ceil(lowpass_filter_width * down / base_freq))

    idx = np.arange(-width, width + down, dtype=np.float64) / down  # [K]
    phase = -np.arange(up, dtype=np.float64) / up                  # [up]
    t = (phase[:, None] + idx[None, :]) * base_freq                # [up, K]
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * math.pi / lowpass_filter_width / 2.0) ** 2  # Hann
    tpi = t * math.pi
    sinc = np.where(tpi == 0.0, 1.0, np.sin(tpi) / np.where(tpi == 0.0, 1.0, tpi))
    bank = (sinc * window * (base_freq / down)).astype(np.float32)
    return bank, width, up, down


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample the last axis of ``x`` from ``orig_freq`` to ``new_freq``.
    The output has ceil(n * new_freq / orig_freq) samples; equal rates
    return ``x``. Integer PCM is resampled as float32."""
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    if int(orig_freq) == int(new_freq):
        return x
    bank, width, up, down = _kernel_bank(int(orig_freq), int(new_freq),
                                         int(lowpass_filter_width), float(rolloff))
    weight = torch.from_numpy(bank).to(device=x.device, dtype=x.dtype)[:, None, :]
    lead, n = x.shape[:-1], x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, n), (width, width + down))
    y = F.conv1d(xb, weight, stride=down)               # [B, up, T']
    y = y.transpose(1, 2).reshape(y.shape[0], -1)       # phases interleaved into time
    target = -(-n * up // down)
    return y[:, :target].reshape(*lead, target)


def resampled_length(n: int, orig_freq: int, new_freq: int) -> int:
    """Output length of :func:`resample`."""
    g = math.gcd(int(orig_freq), int(new_freq))
    return -(-n * (new_freq // g) // (orig_freq // g))
