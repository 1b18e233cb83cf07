"""Static figures, drawn with matplotlib on the host; the signal math (the
mel spectrogram) is the port's own.

* the SHAP-heat spectrogram overlay;
* waveform and per-sample attribution panels;
* the eta_raw-vs-WER scatter of a sweep;
* the faithfulness curves.

matplotlib is imported only inside the functions that draw, so the package
imports where matplotlib is not installed; ``require_matplotlib`` lets a
command refuse before any work there.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from asr_shap_torch.audio.mel import log_mel_spectrogram


def require_matplotlib(what: str, hint: str) -> None:
    """Raise ImportError where matplotlib does not import, naming ``what``
    (the flag or command that asked for a figure) and ``hint`` (how to run
    without it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(f"{what} draws with matplotlib, which does not import here "
                          f"({e}); {hint}") from e


def pyplot():
    import matplotlib

    if matplotlib.get_backend().lower() != "agg" and not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def mel_db_image(audio, sr: int, n_fft: int, hop_length: int, n_mels: int) -> np.ndarray:
    """[mels, frames] dB mel spectrogram of a numpy or torch waveform."""
    mel = log_mel_spectrogram(torch.as_tensor(np.asarray(audio, np.float32)), sr=sr,
                              n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, log="db")
    return mel.cpu().numpy().T


def plot_shap_spectrogram_overlay(
    audio: np.ndarray,
    shap_per_sample: np.ndarray,
    sr: int = 16_000,
    n_fft: int = 1024,
    hop_length: int = 512,
    n_mels: int = 80,
    title: str = "SHAP-weighted spectrogram",
    out_path: Optional[str] = None,
):
    """Mel spectrogram with a per-sample attribution heat band below it."""
    plt = pyplot()
    mel = mel_db_image(audio, sr, n_fft, hop_length, n_mels)
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(12, 6), sharex=False, height_ratios=[4, 1])
    im = ax0.imshow(mel, aspect="auto", origin="lower", cmap="magma")
    ax0.set_title(title)
    ax0.set_ylabel("mel bin")
    fig.colorbar(im, ax=ax0, format="%+2.0f dB")

    t = np.arange(len(audio)) / sr
    heat = np.abs(np.asarray(shap_per_sample))
    ax1.fill_between(t, heat, color="tab:red", alpha=0.8)
    ax1.set_xlabel("time [s]")
    ax1.set_ylabel("|phi|")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_waveform_attribution(
    audio: np.ndarray,
    shap_per_sample: np.ndarray,
    amplified: Optional[np.ndarray] = None,
    sr: int = 16_000,
    out_path: Optional[str] = None,
):
    """Waveform, attribution, and optional SHAP-amplified audio panels."""
    plt = pyplot()
    t = np.arange(len(audio)) / sr
    rows = 3 if amplified is not None else 2
    fig, axes = plt.subplots(rows, 1, figsize=(12, 2.5 * rows), sharex=True)
    axes[0].plot(t, audio, lw=0.4)
    axes[0].set_ylabel("waveform")
    axes[1].plot(t, np.asarray(shap_per_sample), lw=0.4, color="tab:red")
    axes[1].set_ylabel("phi")
    if amplified is not None:
        axes[2].plot(t, amplified, lw=0.4, color="tab:green")
        axes[2].set_ylabel("amplified")
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_eta_wer_scatter(
    records: Sequence[Dict],
    out_path: Optional[str] = "wer_vs_eta_raw_plot.png",
    annotate_corr: bool = True,
):
    """Scatter of eta_raw against WER across the sweep, coloured by SNR."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    snrs = sorted({str(r["snr"]) for r in records})
    cmap = plt.get_cmap("viridis")
    for i, snr in enumerate(snrs):
        pts = [(r["wer"], r["eta_raw"]) for r in records if str(r["snr"]) == snr]
        if not pts:
            continue
        w, e = np.asarray(pts).T
        ax.scatter(w, e, label=f"SNR {snr} dB", color=cmap(i / max(1, len(snrs) - 1)))
    ax.set_xlabel("WER")
    ax.set_ylabel(r"$\eta_{raw}$")
    ax.set_title("Attribution speech-relevance vs transcription quality")
    ax.legend()
    if annotate_corr:
        from asr_shap_torch.pipeline.sweep import correlation

        corr = correlation(list(records))
        if corr is not None:
            ax.annotate(f"Pearson r = {corr:.3f}", xy=(0.02, 0.95), xycoords="axes fraction")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig


def plot_faithfulness_curves(
    records_by_label: Dict[str, Sequence[Dict]],
    out_path: Optional[str] = "faithfulness_curves.png",
):
    """Mean WER-vs-occluded-fraction curves from faithfulness records: one
    colour per label, the attribution ranking solid, the seeded
    random-ranking control dashed. The gap between a label's solid and
    dashed curves is its deletion/insertion faithfulness."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    cmap = plt.get_cmap("viridis")
    labels = list(records_by_label)
    mode = None
    for i, label in enumerate(labels):
        recs = list(records_by_label[label])
        if not recs:
            continue
        mode = recs[0].get("mode", mode)
        fracs = [0.0] + [p["fraction"] for p in recs[0]["points"]]
        topk = np.zeros(len(fracs))
        rand = np.zeros(len(fracs))
        for r in recs:
            topk += [r["base_wer"]] + [p["wer_topk"] for p in r["points"]]
            rand += [r["base_wer"]] + [p["wer_random"] for p in r["points"]]
        topk /= len(recs)
        rand /= len(recs)
        color = cmap(i / max(1, len(labels) - 1))
        ax.plot(fracs, topk, "-o", color=color, label=f"{label} (attribution)")
        ax.plot(fracs, rand, "--", color=color, label=f"{label} (random)")
    ax.set_xlabel("occluded fraction of samples")
    ax.set_ylabel("mean WER")
    ax.set_title(f"{mode or 'occlusion'} faithfulness: attribution ranking vs random control")
    ax.legend()
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    return fig
