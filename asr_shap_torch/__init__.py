"""PyTorch/CUDA port of ``asr_shap`` (expected-gradients SHAP for CTC speech
recognizers), for one NVIDIA Hopper GPU.

The package imports torch and numpy only, never JAX or ``asr_shap``; its
subpackages mirror the reference package's so each counterpart is easy to
find. Entry points (the pipeline, the sweep, and the command line
``python -m asr_shap_torch``) run on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``); there the hand-written kernels' plain
PyTorch versions run instead.
"""
