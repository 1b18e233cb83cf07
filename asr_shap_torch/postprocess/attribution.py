"""Attribution post-processing, on the attributions' device:

* CTC character-group alignment: the first frame of every non-blank,
  non-space, non-repeat token group; the count must equal the
  space-stripped transcription's;
* 20 ms block-mean smoothing (the trailing partial block averaged over its
  true length);
* percentile normalize and clip, with both edge cases (a flat input gives
  ``default``; a threshold at the max gives the binary mask);
* per-character masks and masked audios, batched over the characters;
* frame-to-sample linear interpolation at STFT frame centres;
* repeat-upsampling to spectrogram frames;
* SHAP-weighted and RMS-threshold audio amplification.

Only the character pairing is host Python.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from asr_shap_torch.core.config import PAD_ID, WORD_DELIMITER_ID


def char_group_frames(
    ids: np.ndarray,
    transcription: str,
    blank_id: int = PAD_ID,
    space_id: int = WORD_DELIMITER_ID,
) -> List[int]:
    """Frame index of each character group in a greedy CTC id sequence.

    Raises ValueError when the group count disagrees with the space-stripped
    transcription."""
    ids = np.asarray(ids)
    prev = np.concatenate([[-1], ids[:-1]])
    is_first = (ids != prev) & (ids != blank_id) & (ids != space_id)
    frames = np.nonzero(is_first)[0].tolist()
    clean = transcription.replace(" ", "")
    if len(frames) != len(clean):
        raise ValueError(
            f"char-group/transcription mismatch: {len(frames)} groups vs "
            f"{len(clean)} characters"
        )
    return frames


def block_mean_smooth(x: torch.Tensor, sr: int = 16_000, block_ms: float = 20.0) -> torch.Tensor:
    """Replace each ``block_ms`` window with its mean (trailing partial block
    averaged over its true length). x: [..., N]."""
    n = x.shape[-1]
    blk = max(1, int(block_ms / 1000.0 * sr))
    full = (n // blk) * blk
    head = x[..., :full].reshape(*x.shape[:-1], -1, blk)
    head = head.mean(dim=-1, keepdim=True).expand(head.shape).reshape(*x.shape[:-1], full)
    if full == n:
        return head
    tail = x[..., full:]
    return torch.cat([head, tail.mean(dim=-1, keepdim=True).expand(tail.shape)], dim=-1)


def percentile_last(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """The ``percentile`` of x [..., N] over its last axis, keepdim, by
    linear interpolation between the sorted neighbours, with the
    reference's arithmetic (float32 position q (N - 1), low (1 - w) + high
    w). The same rule as ``torch.quantile``'s "linear", from one sort, and
    with no limit on the input's size (``torch.quantile`` refuses more than
    2^24 elements)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    pos = torch.tensor(percentile, dtype=torch.float32) / 100.0 * float(n - 1)
    low, high = int(torch.floor(pos)), int(torch.ceil(pos))
    w = (pos - torch.floor(pos)).to(x.dtype).to(x.device)
    lo = s[..., min(max(low, 0), n - 1)][..., None]
    hi = s[..., min(max(high, 0), n - 1)][..., None]
    return lo * (1.0 - w) + hi * w


def _normalize_rows(values: torch.Tensor, percentile: float, default: float) -> torch.Tensor:
    """``normalize_and_scale`` of each row of values [..., N] on its own."""
    vmin = values.amin(dim=-1, keepdim=True)
    vmax = values.amax(dim=-1, keepdim=True)
    span = vmax - vmin
    flat = span < 1e-8
    normalized = (values - vmin) / torch.where(flat, torch.ones_like(span), span)
    thr = percentile_last(normalized, percentile)
    binary = (normalized >= thr).to(values.dtype)
    scaled = torch.clamp(
        torch.clamp(normalized - thr, min=0.0) / torch.clamp(1.0 - thr, min=1e-30),
        default, 1.0)
    out = torch.where((1.0 - thr) < 1e-8, binary, scaled)
    return torch.where(flat, torch.full_like(values, default), out)


def normalize_and_scale(values: torch.Tensor, percentile: float = 98.0,
                        default: float = 0.0) -> torch.Tensor:
    """Min-max normalize over all of ``values``, then keep only the mass
    above the given percentile, rescaled to [default..1]."""
    flat = values.reshape(1, -1)
    return _normalize_rows(flat, percentile, default).reshape(values.shape)


def character_masks(
    audio: torch.Tensor,
    shap_matrix: torch.Tensor,
    char_frames: Sequence[int],
    sr: int = 16_000,
    block_ms: float = 20.0,
    percentile: float = 98.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-character SHAP masks and masked audios.

    Returns (masks [C, N], masked_audios [C, N]): per character |phi[:,
    t_char]| -> block smooth -> percentile scale -> audio * mask, all
    characters in one batch."""
    if len(char_frames) == 0:
        empty = torch.zeros((0, audio.shape[-1]), dtype=audio.dtype, device=audio.device)
        return empty, empty
    frames = torch.as_tensor(list(char_frames), device=shap_matrix.device)
    cols = shap_matrix[:, frames].T.abs()  # [C, N]
    masks = _normalize_rows(block_mean_smooth(cols, sr, block_ms), percentile, 0.0)
    return masks, audio[None, :] * masks


def frame_to_sample_interp(frame_values: torch.Tensor, n_samples: int, hop_length: int,
                           n_fft: int) -> torch.Tensor:
    """Linear interpolation of per-STFT-frame values [..., T] onto
    ``n_samples`` audio samples, anchored at the frame centres; before the
    first centre and after the last the end values hold (``jnp.interp``'s
    rule)."""
    fp = frame_values.to(torch.float32)
    t = fp.shape[-1]
    dev = fp.device
    if t == 1:
        return fp.expand(*fp.shape[:-1], n_samples).clone()
    xp = (torch.arange(t, device=dev) * hop_length + n_fft // 2).to(torch.float32)
    x = torch.arange(n_samples, device=dev).to(torch.float32)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, t - 1)
    f0, f1 = fp[..., i - 1], fp[..., i]
    out = f0 + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (f1 - f0)
    out = torch.where(x < xp[0], fp[..., :1], out)
    return torch.where(x > xp[-1], fp[..., -1:], out)


def repeat_upsample(frame_values: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsampling by integer repeat along the last axis."""
    return torch.repeat_interleave(frame_values, factor, dim=-1)


def shap_amplify(audio: torch.Tensor, shap_matrix: torch.Tensor,
                 factor: float = 2.0) -> torch.Tensor:
    """SHAP-weighted audio amplification: mean attribution over output
    frames, min-max normalized (a flat input gives all ones), then
    ``audio * (1 + norm * factor)``."""
    per_sample = shap_matrix.mean(dim=-1)  # [N]
    lo, hi = per_sample.min(), per_sample.max()
    flat = (hi - lo) < 1e-12
    norm = torch.where(flat, torch.ones_like(per_sample),
                       (per_sample - lo) / torch.where(flat, torch.ones_like(hi), hi - lo))
    return audio * (1.0 + norm * factor)


def rms_frames(audio: torch.Tensor, frame_length: int = 2048,
               hop_length: int = 512) -> torch.Tensor:
    """Per-frame RMS energy, librosa.feature.rms semantics (centred frames,
    zero padding; 1 + N // hop frames)."""
    n = audio.shape[-1]
    pad = frame_length // 2
    n_frames = 1 + n // hop_length
    # zeros past the padded clip, so every frame is whole
    tail = max(0, (n_frames - 1) * hop_length + frame_length - (n + 2 * pad))
    y = torch.nn.functional.pad(audio, (pad, pad + tail))
    frames = y.unfold(-1, frame_length, hop_length)[..., :n_frames, :]
    return torch.sqrt(frames.square().mean(dim=-1))


def amplify_quiet_sections(
    audio: torch.Tensor,
    frame_length: int = 2048,
    hop_length: int = 512,
    energy_threshold: float = 0.01,
    amplification_factor: float = 5.0,
) -> torch.Tensor:
    """RMS-threshold quiet-section amplification: every frame whose RMS is
    below ``energy_threshold`` multiplies its [i*hop, i*hop+frame_length)
    span by the factor (overlapping quiet frames compound), then the result
    clips to [-1, 1]. The per-sample count of covering quiet frames is a
    cumulative sum of +1 at each quiet frame's start and -1 at its end."""
    n = audio.shape[-1]
    quiet = (rms_frames(audio, frame_length, hop_length) < energy_threshold).to(audio.dtype)
    starts = torch.arange(quiet.shape[0], device=audio.device) * hop_length
    steps = torch.zeros(n + frame_length + 1, dtype=audio.dtype, device=audio.device)
    keep = starts < n
    steps.index_add_(0, starts[keep], quiet[keep])
    steps.index_add_(0, starts[keep] + frame_length, -quiet[keep])
    counts = torch.cumsum(steps, dim=0)[:n]
    gain = amplification_factor ** torch.round(counts)
    return torch.clamp(audio * gain, -1.0, 1.0)
