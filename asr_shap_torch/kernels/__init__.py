"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, and the launch counts that show a run went through them."""

from asr_shap_torch.kernels._build import LAUNCHES, build_all, reset_launches

__all__ = ["LAUNCHES", "build_all", "reset_launches"]
