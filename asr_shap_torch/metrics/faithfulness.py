"""Deletion/insertion faithfulness curves for waveform attributions.

A second axis of attribution quality beside eta_raw, which needs no
ground-truth mask: does removing the top-attributed samples destroy the
transcript faster than removing random ones?

Per sample:
  * importance[n] = sum_t |phi[n, t]|, the per-sample relevance that eta_raw
    segments, so both metrics grade one ranking;
  * for each fraction f: mask (deletion) or keep (insertion) the top-f
    fraction of samples by importance, fill with zeros or seeded noise,
    transcribe, and score the WER against the reference text;
  * controls: the same fractions with seeded uniform-random rankings;
  * summary: the area under WER(fraction) (trapezoid). Faithful
    attributions give a deletion AUC above the random control and an
    insertion AUC below it.

The masked variants come from numpy's generator, as the reference's, so
they equal its variants. All variants of one clip are transcribed in one
batched forward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import WAV2VEC2_VOCAB
from asr_shap_torch.core.device import matmul_precision_scope, params_device
from asr_shap_torch.metrics.wer import batch_wer
from asr_shap_torch.models.heads import model_logits_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute
from asr_shap_torch.ops.ctc import ctc_decode_batch

DEFAULT_FRACTIONS = (0.01, 0.02, 0.05, 0.1, 0.2)


def importance_per_sample(shap_matrix: np.ndarray, n_audio: int) -> np.ndarray:
    """[N, T] / [T, N] / [N] attribution -> per-sample importance [N] (the
    orientation fix-up and |.|-sum of metrics/eta_raw.py)."""
    phi = np.asarray(shap_matrix)
    if phi.ndim == 1:
        return np.abs(phi)
    if phi.shape[0] != n_audio and phi.shape[1] == n_audio:
        phi = phi.T
    return np.abs(phi).sum(axis=-1)


def _topk_mask(order: np.ndarray, n: int, fraction: float) -> np.ndarray:
    """Boolean [n] mask, True on the first ceil(f * n) entries of ``order``."""
    mask = np.zeros(n, bool)
    mask[order[:int(np.ceil(fraction * n))]] = True
    return mask


def masked_variants(audio: np.ndarray, importance: np.ndarray, fractions: Sequence[float],
                    mode: str = "deletion", fill: str = "zero", n_random: int = 3,
                    seed: int = 0) -> tuple[np.ndarray, List[Dict]]:
    """The batch of masked clips of one faithfulness curve: (variants
    [1 + len(fractions) * (1 + n_random), N], meta) with meta[i] = {"kind":
    "orig" | "topk" | "random", "fraction": f, "rep": r}. "deletion" masks
    the selected samples, "insertion" everything else; ``fill`` is "zero" or
    "noise" (seeded Gaussian at the clip's RMS)."""
    if mode not in ("deletion", "insertion"):
        raise ValueError(f"unknown mode {mode!r}")
    audio = np.asarray(audio, np.float32)
    n = audio.shape[0]
    rng = np.random.default_rng(seed)
    if fill == "zero":
        filler = np.zeros(n, np.float32)
    elif fill == "noise":
        rms = float(np.sqrt(np.mean(np.square(audio)))) or 1.0
        filler = rng.standard_normal(n).astype(np.float32) * rms
    else:
        raise ValueError(f"unknown fill {fill!r}")

    orders = {"topk": np.argsort(-np.asarray(importance), kind="stable")}
    for r in range(n_random):
        orders[f"random{r}"] = rng.permutation(n)

    variants = [audio]
    meta: List[Dict] = [{"kind": "orig", "fraction": 0.0, "rep": 0}]
    for f in fractions:
        for name, order in orders.items():
            sel = _topk_mask(order, n, f)
            if mode == "insertion":
                sel = ~sel
            variants.append(np.where(sel, filler, audio))
            meta.append({"kind": "topk" if name == "topk" else "random",
                         "fraction": float(f),
                         "rep": 0 if name == "topk" else int(name[6:])})
    return np.stack(variants), meta


def curve_auc(fractions: Sequence[float], wers: Sequence[float]) -> float:
    """Trapezoid area under WER(fraction) over the fraction span (the
    caller prepends fraction 0 with the unmasked WER)."""
    f = np.asarray(fractions, np.float64)
    w = np.asarray(wers, np.float64)
    span = f[-1] - f[0]
    return float(np.trapezoid(w, f) / span) if span > 0 else float(w.mean())


def faithfulness_curve(transcribe_fn: Callable[[np.ndarray], List[str]], audio: np.ndarray,
                       shap_matrix: np.ndarray, reference_text: str,
                       fractions: Sequence[float] = DEFAULT_FRACTIONS,
                       mode: str = "deletion", fill: str = "zero", n_random: int = 3,
                       seed: int = 0) -> Dict:
    """One sample's record: {mode, fill, base_wer, points: [{fraction,
    wer_topk, wer_random (mean over reps)}], auc_topk, auc_random, auc_gap};
    auc_gap is auc_topk - auc_random for deletion and auc_random - auc_topk
    for insertion (positive = faithful). ``transcribe_fn([B, N] float32)``
    returns B transcripts."""
    audio = np.asarray(audio, np.float32)
    importance = importance_per_sample(shap_matrix, audio.shape[0])
    variants, meta = masked_variants(audio, importance, fractions, mode, fill, n_random, seed)
    texts = transcribe_fn(variants)
    wers = batch_wer([reference_text] * len(texts), texts)

    base = wers[0]
    points = []
    for f in fractions:
        topk = [w for w, m in zip(wers, meta) if m["kind"] == "topk" and m["fraction"] == float(f)]
        rand = [w for w, m in zip(wers, meta)
                if m["kind"] == "random" and m["fraction"] == float(f)]
        points.append({"fraction": float(f), "wer_topk": float(np.mean(topk)),
                       "wer_random": float(np.mean(rand))})

    grid = [0.0] + [p["fraction"] for p in points]
    auc_topk = curve_auc(grid, [base] + [p["wer_topk"] for p in points])
    auc_random = curve_auc(grid, [base] + [p["wer_random"] for p in points])
    gap = auc_topk - auc_random if mode == "deletion" else auc_random - auc_topk
    return {"mode": mode, "fill": fill, "base_wer": float(base), "points": points,
            "auc_topk": auc_topk, "auc_random": auc_random, "auc_gap": float(gap)}


def make_transcribe_fn(params, model_cfg, logits_fn=None,
                       vocab: Sequence[str] = WAV2VEC2_VOCAB
                       ) -> Callable[[np.ndarray], List[str]]:
    """Batched greedy transcription: [B, N] numpy waveforms -> B transcripts,
    one forward per call on the params' device, inside the config's
    precision scope. ``logits_fn`` defaults to the config's family. A bf16
    config's params are cast once, here."""
    logits_fn = logits_fn or model_logits_fn(model_cfg)
    device = params_device(params)
    params = cast_params_for_compute(params, model_cfg.dtype)

    def transcribe(batch: np.ndarray) -> List[str]:
        x = torch.as_tensor(np.asarray(batch, np.float32), device=device)
        with torch.no_grad(), matmul_precision_scope(model_cfg.matmul_precision):
            logits = logits_fn(params, model_cfg, zero_mean_unit_var(x))
        return ctc_decode_batch(logits, vocab=vocab)

    return transcribe


def faithfulness_summary(records: Sequence[Dict], n_boot: int = 2000, seed: int = 0) -> Dict:
    """Mean AUCs and gap over per-sample records, with a bootstrap 95% CI and
    the share of positive gaps (positive = the ranking beats random)."""
    gaps = np.asarray([r["auc_gap"] for r in records], np.float64)
    rng = np.random.default_rng(seed)
    if len(gaps) > 1:
        idx = rng.integers(0, len(gaps), size=(n_boot, len(gaps)))
        lo, hi = np.percentile(gaps[idx].mean(axis=1), [2.5, 97.5])
    else:
        lo = hi = float(gaps.mean()) if len(gaps) else 0.0
    return {
        "n": len(records),
        "mean_auc_topk": float(np.mean([r["auc_topk"] for r in records])),
        "mean_auc_random": float(np.mean([r["auc_random"] for r in records])),
        "mean_auc_gap": float(gaps.mean()) if len(gaps) else 0.0,
        "gap_ci95": [float(lo), float(hi)],
        "frac_gap_positive": float(np.mean(gaps > 0)) if len(gaps) else 0.0,
    }
