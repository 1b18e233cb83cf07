"""Device selection and float32 precision switches for the port."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The port's entry points run on CUDA unless the caller asks for the
    CPU; asking for CUDA where there is none raises instead of falling
    back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def check_matmul_precision(precision: str) -> None:
    """Only ``matmul_precision="highest"`` (float32, TF32 off) is ported."""
    if precision != "highest":
        raise NotImplementedError(
            f"matmul_precision {precision!r}: only 'highest' is ported")


def tf32_enabled() -> bool:
    """Whether cuBLAS matmuls or cuDNN convolutions may round to TF32."""
    return bool(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def highest_precision() -> Iterator[None]:
    """TF32 off for cuBLAS matmuls AND cuDNN convolutions (cuDNN's default
    is TF32) inside the block; the previous switches come back after it.
    The block must hold the forward and the backward: the explainer's
    backward runs after the forward has returned."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
