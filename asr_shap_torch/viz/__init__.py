from asr_shap_torch.viz.interactive import AttributionViewer, load_attribution_view
from asr_shap_torch.viz.static import (
    plot_eta_wer_scatter,
    plot_shap_spectrogram_overlay,
    plot_waveform_attribution,
)
from asr_shap_torch.viz.wav_io import write_wav

__all__ = [
    "write_wav",
    "plot_eta_wer_scatter",
    "plot_shap_spectrogram_overlay",
    "plot_waveform_attribution",
    "AttributionViewer",
    "load_attribution_view",
]
