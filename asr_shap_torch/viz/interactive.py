"""Interactive attribution viewer: a clickable per-character transcription
whose selection shows that character's SHAP-masked mel spectrogram, a token
timeline with pads shown as dots, and a wav-export button. Every mask is
computed in one batched pass (``postprocess.character_masks``), so a click
only swaps image data.

Works headless (Agg) for tests and export; the event wiring acts under an
interactive backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import PAD_ID, WAV2VEC2_VOCAB, Wav2Vec2ConformerConfig
from asr_shap_torch.core.device import matmul_precision_scope, params_device
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute, wav2vec2_logits
from asr_shap_torch.ops.ctc import ctc_decode_batch
from asr_shap_torch.postprocess import char_group_frames, character_masks
from asr_shap_torch.viz.static import mel_db_image, pyplot
from asr_shap_torch.viz.wav_io import write_wav


@dataclass
class AttributionView:
    """Everything the viewer needs, precomputed."""

    audio: np.ndarray
    sr: int
    transcription: str
    display_tokens: List[str]      # per-frame tokens, pad -> "·"
    char_frames: List[int]
    masks: np.ndarray              # [C, N]
    masked_audios: np.ndarray      # [C, N]


def load_attribution_view(
    params,
    model_config,
    audio: np.ndarray,
    shap_values: np.ndarray,
    sr: int = 16_000,
    block_ms: float = 20.0,
    percentile: float = 98.0,
) -> AttributionView:
    """Build an AttributionView from raw (audio, shap): the Wav2Vec2
    forward on the params' device (inside the config's precision scope),
    greedy decoding, and the batched post-processing on the same device. A
    Wav2Vec2-Conformer config raises ValueError: the view is Wav2Vec2's."""
    if isinstance(model_config, Wav2Vec2ConformerConfig):
        raise ValueError("the attribution view runs the Wav2Vec2 forward; a "
                         f"{type(model_config).__name__} is not supported")
    device = params_device(params)
    audio_t = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    params = cast_params_for_compute(params, model_config.dtype)
    with torch.no_grad(), matmul_precision_scope(model_config.matmul_precision):
        logits = wav2vec2_logits(params, model_config, zero_mean_unit_var(audio_t)[None])
    transcription = ctc_decode_batch(logits)[0]
    ids = logits[0].argmax(dim=-1).cpu().numpy()
    display_tokens = ["·" if i == PAD_ID else WAV2VEC2_VOCAB[i] for i in ids]

    phi = np.asarray(shap_values)
    if phi.ndim == 2 and phi.shape[0] != len(audio) and phi.shape[1] == len(audio):
        phi = phi.T  # a [T, N] matrix, transposed

    char_frames = char_group_frames(ids, transcription)
    masks, masked = character_masks(audio_t, torch.as_tensor(phi, device=device),
                                    char_frames, sr, block_ms, percentile)
    return AttributionView(
        audio=np.asarray(audio),
        sr=sr,
        transcription=transcription,
        display_tokens=display_tokens,
        char_frames=char_frames,
        masks=masks.cpu().numpy(),
        masked_audios=masked.cpu().numpy(),
    )


class AttributionViewer:
    """Matplotlib UI: click a character to see its SHAP-weighted mel
    spectrogram; the export button writes its masked audio as wav."""

    def __init__(self, view: AttributionView, n_fft: int = 1024,
                 hop_length: int = 512, n_mels: int = 80):
        self.view = view
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.selected = 0
        self._mel_cache: dict[int, np.ndarray] = {}
        self._build()

    # ------------------------------------------------------------ internals

    def _mel(self, idx: Optional[int]) -> np.ndarray:
        key = -1 if idx is None else idx
        if key not in self._mel_cache:
            audio = self.view.audio if idx is None else self.view.masked_audios[idx]
            self._mel_cache[key] = mel_db_image(audio, self.view.sr, self.n_fft,
                                           self.hop_length, self.n_mels)
        return self._mel_cache[key]

    def _build(self):
        plt = pyplot()
        from matplotlib.widgets import Button

        chars = list(self.view.transcription.replace(" ", ""))
        self.fig = plt.figure(figsize=(14, 8))
        gs = self.fig.add_gridspec(3, 1, height_ratios=[5, 1, 1])
        self.ax_spec = self.fig.add_subplot(gs[0])
        self.ax_chars = self.fig.add_subplot(gs[1])
        self.ax_tokens = self.fig.add_subplot(gs[2])

        self.im = self.ax_spec.imshow(self._mel(None), aspect="auto", origin="lower",
                                      cmap="magma")
        self.ax_spec.set_title("full audio (click a character below)")
        self.ax_spec.set_ylabel("mel bin")

        # clickable character row
        self.ax_chars.set_xlim(0, max(1, len(chars)))
        self.ax_chars.set_ylim(0, 1)
        self.ax_chars.axis("off")
        self._char_texts = []
        for i, ch in enumerate(chars):
            t = self.ax_chars.text(i + 0.5, 0.5, ch, ha="center", va="center",
                                   fontsize=14, picker=True)
            t.char_index = i
            self._char_texts.append(t)

        # token timeline (pads as dots)
        toks = self.view.display_tokens
        self.ax_tokens.set_xlim(0, max(1, len(toks)))
        self.ax_tokens.set_ylim(0, 1)
        self.ax_tokens.axis("off")
        step = max(1, len(toks) // 120)
        for i in range(0, len(toks), step):
            self.ax_tokens.text(i + 0.5, 0.5, toks[i], ha="center", va="center",
                                fontsize=6, color="gray")

        ax_btn = self.fig.add_axes([0.85, 0.01, 0.13, 0.045])
        self.btn_export = Button(ax_btn, "export wav")
        self.btn_export.on_clicked(lambda _ev: self.export_selected())

        self.fig.canvas.mpl_connect("pick_event", self._on_pick)

    def _on_pick(self, event):
        idx = getattr(event.artist, "char_index", None)
        if idx is not None:
            self.select(idx)

    # -------------------------------------------------------------- actions

    def select(self, char_index: int):
        """Show the SHAP-masked spectrogram of one character."""
        self.selected = int(char_index)
        self.im.set_data(self._mel(self.selected))
        self.im.autoscale()
        ch = self.view.transcription.replace(" ", "")[self.selected]
        self.ax_spec.set_title(f"character {self.selected}: '{ch}' "
                               f"(frame {self.view.char_frames[self.selected]})")
        for i, t in enumerate(self._char_texts):
            t.set_color("tab:red" if i == self.selected else "black")
        self.fig.canvas.draw_idle()

    def export_selected(self, path: Optional[str] = None) -> str:
        path = path or f"char_{self.selected}_masked.wav"
        write_wav(path, self.view.masked_audios[self.selected], self.view.sr)
        return path

    def export_full(self, path: str = "full_audio.wav") -> str:
        write_wav(path, self.view.audio, self.view.sr)
        return path

    def savefig(self, path: str):
        self.fig.savefig(path, dpi=120)

    def show(self):
        pyplot().show()
