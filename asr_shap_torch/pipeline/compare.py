"""LIME-vs-SHAP comparison harness: the same clip explained by the LIME
linear surrogate and by expected-gradients SHAP, their agreement, a 4-panel
comparison figure and amplified-audio wav exports.

The flow (the reference's ``asr_shap/pipeline/compare.py``):
  * a centred ``clip_seconds`` window of the clip, short clips zero-padded;
  * SHAP: expected gradients through the mean-over-vocab head ("mean"),
    ``ExplainerConfig``'s ``nsamples``, ``num_background``,
    ``background_sigma`` and ``output_chunk``;
  * LIME over raw-waveform segments through the mean-over-vocab-and-time
    head ("mean_time"), the ``lime_*`` knobs, one batched forward per 16
    perturbed clips;
  * Pearson r of the per-sample attributions, and over LIME's segments.

The run's streams come from ``core.prng`` over the reference's fold paths:
the background from ``generator(seed, 0)``, the expected-gradients draws
from ``generator(seed, 1)``, the LIME masks from ``generator(seed, 2)``.
An explicit ``background``, ``draws`` or ``masks`` replaces its stream (the
tests feed the reference's). The model's family follows the config
(``models.heads.model_logits_fn``); everything runs where the params are,
inside the config's matmul precision scope.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import ExplainerConfig, Wav2Vec2Config
from asr_shap_torch.core.device import matmul_precision_scope, params_device
from asr_shap_torch.core.prng import generator
from asr_shap_torch.explain.baselines import zeros_noise_background
from asr_shap_torch.explain.expected_gradients import Draws, expected_phi
from asr_shap_torch.explain.lime import lime_attributions
from asr_shap_torch.models.heads import make_batched_fn, make_explained_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute
from asr_shap_torch.postprocess.attribution import shap_amplify
from asr_shap_torch.viz.static import require_matplotlib
from asr_shap_torch.viz.wav_io import write_wav

logger = logging.getLogger(__name__)

_BACKGROUND, _DRAWS, _MASKS = 0, 1, 2  # generator streams of one comparison


def center_window(audio: np.ndarray, n_target: int) -> np.ndarray:
    """Centred ``n_target``-sample window; short clips zero-padded at the
    end."""
    n = len(audio)
    if n >= n_target:
        start = (n - n_target) // 2
        return np.asarray(audio[start : start + n_target], np.float32)
    return np.pad(np.asarray(audio, np.float32), (0, n_target - n))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lime_shap_comparison(
    params,
    model_cfg: Wav2Vec2Config,
    explainer_cfg: ExplainerConfig,
    audio: np.ndarray,
    seed: int = 0,
    sr: int = 16_000,
    clip_seconds: float = 2.0,
    amplification: float = 2.0,
    out_dir: Optional[str] = None,
    prefix: str = "lime_shap_comparison",
    background: Optional[torch.Tensor] = None,
    draws: Optional[Draws] = None,
    masks: Optional[torch.Tensor] = None,
) -> Dict:
    """Explain one clip with both methods; return the per-sample
    attributions, their agreement statistics and (with ``out_dir``) the
    artifact paths. With ``out_dir`` and no matplotlib, raises before any
    work."""
    if out_dir:
        require_matplotlib(f"out_dir {out_dir!r}", "pass out_dir=None for the record alone")
    ec = explainer_cfg
    device = params_device(params)
    params = cast_params_for_compute(params, model_cfg.dtype)
    clip = center_window(audio, int(round(clip_seconds * sr)))
    x = zero_mean_unit_var(torch.from_numpy(clip).to(device))
    n = int(x.shape[0])
    if background is None:
        background = zeros_noise_background(generator(seed, _BACKGROUND), n,
                                            ec.num_background, ec.background_sigma,
                                            device=device)

    with matmul_precision_scope(model_cfg.matmul_precision):
        # SHAP: expected gradients through the mean-over-vocab head
        f = make_explained_fn(params, model_cfg, dataclasses.replace(ec, aggregation="mean"))
        t0 = time.perf_counter()
        phi = expected_phi(f, x, background.to(device), generator(seed, _DRAWS), ec,
                           draws=draws)  # [N, T]
        _sync(device)
        shap_wall = time.perf_counter() - t0

        # LIME: the mean-over-vocab-and-time head, the lime_* knobs
        f_batch = make_batched_fn(params, model_cfg,
                                  dataclasses.replace(ec, aggregation="mean_time"))
        t0 = time.perf_counter()
        lime_vals = lime_attributions(
            f_batch, x, generator(seed, _MASKS), num_segments=ec.lime_num_segments,
            num_samples=ec.lime_num_samples, keep_prob=ec.lime_keep_prob,
            ridge_alpha=ec.lime_ridge_alpha, masks=masks).values  # [N, 1]
        _sync(device)
        lime_wall = time.perf_counter() - t0

    phi_shap = phi.cpu().numpy()
    shap_per_sample = phi_shap.mean(axis=-1)
    lime_per_sample = lime_vals[:, 0].cpu().numpy()

    # agreement: Pearson r over the per-sample attributions and over coarse
    # segments (per-sample LIME is piecewise constant by construction, so
    # the segment view is the honest granularity); the segments are LIME's
    # own ceil split, so the averaged windows sit on its boundaries
    pearson = _nan_safe_corr(shap_per_sample, lime_per_sample)
    seg = max(1, -(-n // max(1, ec.lime_num_segments)))
    n_seg = -(-n // seg)
    pad = n_seg * seg - n
    seg_shap = np.pad(shap_per_sample, (0, pad)).reshape(n_seg, seg)
    seg_lime = np.pad(lime_per_sample, (0, pad)).reshape(n_seg, seg)
    counts = np.minimum(seg, np.maximum(0, n - seg * np.arange(n_seg)))
    seg_shap = seg_shap.sum(axis=1) / counts
    seg_lime = seg_lime.sum(axis=1) / counts
    seg_pearson = _nan_safe_corr(seg_shap, seg_lime)

    result = {
        "clip_samples": n,
        "shap_per_sample": shap_per_sample,
        "lime_per_sample": lime_per_sample,
        "shap_matrix": phi_shap,
        "pearson_r": pearson,
        "pearson_r_segments": seg_pearson,
        "shap_wall_s": round(shap_wall, 3),
        "lime_wall_s": round(lime_wall, 3),
        "lime_num_samples": ec.lime_num_samples,
        "shap_nsamples": ec.nsamples,
    }

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fig_path = os.path.join(out_dir, f"{prefix}.png")
        _comparison_figure(clip, sr, shap_per_sample, lime_per_sample, fig_path)
        shap_wav = os.path.join(out_dir, f"{prefix}_shap_amplified.wav")
        lime_wav = os.path.join(out_dir, f"{prefix}_lime_amplified.wav")
        amp_shap, amp_lime = amplified_pair(x.new_tensor(clip), phi, lime_vals, amplification)
        write_wav(shap_wav, amp_shap, sr)
        write_wav(lime_wav, amp_lime, sr)
        result.update({"figure": fig_path, "shap_wav": shap_wav, "lime_wav": lime_wav})
        # the agreement statistics are what the harness measures: keep them
        # beside the figure
        stats_path = os.path.join(out_dir, f"{prefix}_stats.json")
        with open(stats_path, "w") as fh:
            fh.write(comparison_record(result) + "\n")
        result["stats"] = stats_path
        logger.info("comparison artifacts written under %s", out_dir)
    return result


def amplified_pair(clip: torch.Tensor, phi: torch.Tensor, lime_vals: torch.Tensor,
                   amplification: float = 2.0):
    """The two wavs' samples (numpy): the clip amplified by SHAP's phi [N, T]
    and by LIME's values [N, 1], both divided by their common peak (at
    least 1)."""
    amp_shap = shap_amplify(clip, phi, amplification).cpu().numpy()
    amp_lime = shap_amplify(clip, lime_vals, amplification).cpu().numpy()
    peak = max(np.abs(amp_shap).max(), np.abs(amp_lime).max(), 1.0)
    return amp_shap / peak, amp_lime / peak


def _nan_safe_corr(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    if a.std() == 0 or b.std() == 0:
        return None
    return float(np.corrcoef(a, b)[0, 1])


def _norm01(v: np.ndarray) -> np.ndarray:
    lo, hi = v.min(), v.max()
    return (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)


def _comparison_figure(clip, sr, shap_ps, lime_ps, out_path: str) -> None:
    """4-panel figure: waveform, LIME attribution, SHAP attribution,
    normalized overlay."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.arange(len(clip)) / sr
    fig, axes = plt.subplots(4, 1, figsize=(12, 10), sharex=True)
    axes[0].plot(t, clip, lw=0.4, color="black")
    axes[0].set_title("waveform")
    axes[1].plot(t, lime_ps, lw=0.5, color="tab:orange")
    axes[1].set_title("LIME attribution (per sample)")
    axes[2].plot(t, shap_ps, lw=0.5, color="tab:blue")
    axes[2].set_title("SHAP attribution (mean over output frames)")
    axes[3].plot(t, _norm01(lime_ps), lw=0.5, color="tab:orange", label="LIME")
    axes[3].plot(t, _norm01(shap_ps), lw=0.5, color="tab:blue", label="SHAP", alpha=0.7)
    axes[3].set_title("normalized comparison")
    axes[3].set_xlabel("time [s]")
    axes[3].legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def comparison_record(result: Dict) -> str:
    """One JSON line of the scalar fields (arrays dropped) for artifact logs."""
    return json.dumps({k: v for k, v in result.items() if not isinstance(v, np.ndarray)})
