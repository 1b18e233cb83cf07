"""Spectrogram audio scrubber: hover over a mel spectrogram to see the
frame, click to hear (or export) the audio around it, rebuilt from the mel
power by Griffin-Lim (``audio.invert.mel_to_audio``) on the scrubber's
device. Playback goes through ``sounddevice`` where it imports; elsewhere a
click writes a wav file.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from asr_shap_torch.audio.invert import mel_to_audio
from asr_shap_torch.audio.mel import log_mel_spectrogram
from asr_shap_torch.core.device import resolve_device
from asr_shap_torch.viz.static import pyplot
from asr_shap_torch.viz.wav_io import write_wav


def _try_sounddevice():
    try:
        import sounddevice

        return sounddevice
    except Exception:
        return None


class SpectrogramScrubber:
    def __init__(
        self,
        audio: np.ndarray,
        sr: int = 16_000,
        n_fft: int = 1024,
        hop_length: int = 512,
        n_mels: int = 80,
        context_frames: int = 4,
        device: str | torch.device = "cuda",
    ):
        self.audio = np.asarray(audio, np.float32)
        self.sr = sr
        self.n_fft = n_fft
        self.hop = hop_length
        self.context = context_frames
        self.device = resolve_device(device)
        self.sd = _try_sounddevice()

        x = torch.from_numpy(self.audio).to(self.device)
        kw = dict(sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
        self.mel_power = log_mel_spectrogram(x, log="none", **kw)  # on the device
        self.mel_db = log_mel_spectrogram(x, log="db", **kw).cpu().numpy()
        self._build()

    def _build(self):
        plt = pyplot()
        self.fig, self.ax = plt.subplots(figsize=(12, 5))
        self.ax.imshow(self.mel_db.T, aspect="auto", origin="lower", cmap="magma")
        self.ax.set_xlabel("frame")
        self.ax.set_ylabel("mel bin")
        self.ax.set_title("hover to scrub; click to play/export the local audio")
        self.cursor = self.ax.axvline(0, color="cyan", lw=1)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_move)
        self.fig.canvas.mpl_connect("button_press_event", self._on_click)

    def frame_audio(self, frame: int) -> np.ndarray:
        """Griffin-Lim reconstruction of a window around ``frame``."""
        lo = max(0, frame - self.context)
        hi = min(self.mel_power.shape[0], frame + self.context + 1)
        length = self.hop * (hi - lo - 1) + self.n_fft // 2
        return mel_to_audio(self.mel_power[lo:hi], self.sr, self.n_fft, self.hop, length,
                            n_iter=16).cpu().numpy()

    def _on_move(self, event):
        if event.inaxes is self.ax and event.xdata is not None:
            self.cursor.set_xdata([event.xdata])
            self.fig.canvas.draw_idle()

    def _on_click(self, event):
        if event.inaxes is not self.ax or event.xdata is None:
            return
        frame = int(round(event.xdata))
        clip = self.frame_audio(frame)
        if self.sd is not None:
            self.sd.play(clip, self.sr)
        else:
            path = f"scrub_frame_{frame}.wav"
            write_wav(path, clip, self.sr)
            self.ax.set_title(f"no sound device — wrote {path}")
            self.fig.canvas.draw_idle()

    def export_frame(self, frame: int, path: Optional[str] = None) -> str:
        path = path or f"scrub_frame_{frame}.wav"
        write_wav(path, self.frame_audio(frame), self.sr)
        return path

    def show(self):
        pyplot().show()
