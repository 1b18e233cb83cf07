from asr_shap_torch.explain.baselines import kmeans_background, zeros_noise_background
from asr_shap_torch.explain.deepshap import (
    DeepExplanation,
    deep_explain_wav2vec2,
    deep_shap_values,
    dual,
    gelu_rescale,
    glu_rescale,
    relu_rescale,
    sigmoid_rescale,
    silu_rescale,
    tanh_rescale,
    w2v2_conformer_dual_fn,
    wav2vec2_dual_fn,
)
from asr_shap_torch.explain.expected_gradients import (
    Explanation,
    GradientExplainer,
    expected_gradients,
)
from asr_shap_torch.explain.kernel_shap import KernelShapExplanation, kernel_shap_attributions
from asr_shap_torch.explain.lime import LimeExplanation, lime_attributions

__all__ = [
    "Explanation",
    "GradientExplainer",
    "expected_gradients",
    "zeros_noise_background",
    "kmeans_background",
    "DeepExplanation",
    "deep_shap_values",
    "deep_explain_wav2vec2",
    "wav2vec2_dual_fn",
    "w2v2_conformer_dual_fn",
    "dual",
    "silu_rescale",
    "gelu_rescale",
    "sigmoid_rescale",
    "tanh_rescale",
    "relu_rescale",
    "glu_rescale",
    "LimeExplanation",
    "lime_attributions",
    "KernelShapExplanation",
    "kernel_shap_attributions",
]
