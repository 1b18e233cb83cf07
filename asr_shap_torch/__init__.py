"""PyTorch/CUDA port of ``asr_shap`` (expected-gradients SHAP for CTC speech
recognizers), for one NVIDIA Hopper GPU.

The package imports torch and numpy only, never JAX or ``asr_shap``; its
subpackages mirror the reference package's so each counterpart is easy to
find. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
there the hand-written kernels' plain PyTorch versions run instead.
"""
