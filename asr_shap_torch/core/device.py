"""Device selection and the matmul precision switches for the port."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple

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


# The switches each matmul_precision sets: (cuBLAS TF32, cuDNN TF32, cuBLAS
# bf16 reduced-precision reductions). "highest": float32 products in float32
# and bf16 products summed in float32, as the reference's
# preferred_element_type. "default": the libraries may use TF32 (the H100's
# counterpart of the TPU's bf16 passes), and bf16 GEMMs keep PyTorch's own
# default. The port's float32 kernels are 3xTF32 under either.
PRECISION_SWITCHES: Dict[str, Tuple[bool, bool, bool]] = {
    "highest": (False, False, False),
    "default": (True, True, True),
}


def params_device(params) -> torch.device:
    """The device of a params tree (its first leaf's): where the entry points
    that take params run, with no fallback."""
    while isinstance(params, (dict, list, tuple)):
        params = next(iter(params.values())) if isinstance(params, dict) else params[0]
    return params.device


def check_matmul_precision(precision: str) -> None:
    """``matmul_precision`` "highest" or "default"; anything else raises."""
    if precision not in PRECISION_SWITCHES:
        raise NotImplementedError(
            f"matmul_precision {precision!r}: only {sorted(PRECISION_SWITCHES)} are ported")


def _switches() -> Tuple[bool, bool, bool]:
    m = torch.backends.cuda.matmul
    return (bool(m.allow_tf32), bool(torch.backends.cudnn.allow_tf32),
            bool(m.allow_bf16_reduced_precision_reduction))


def _set_switches(switches: Tuple[bool, bool, bool]) -> None:
    m = torch.backends.cuda.matmul
    m.allow_tf32, torch.backends.cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction = (
        switches)


def precision_active(precision: str) -> bool:
    """Whether torch's switches are the ones ``matmul_precision_scope(precision)``
    sets."""
    check_matmul_precision(precision)
    return _switches() == PRECISION_SWITCHES[precision]


def tf32_enabled() -> bool:
    """Whether cuBLAS matmuls or cuDNN convolutions may round to TF32."""
    return bool(torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)


@contextlib.contextmanager
def matmul_precision_scope(precision: str) -> Iterator[None]:
    """The switches of ``precision`` (``PRECISION_SWITCHES``) for cuBLAS
    matmuls AND cuDNN convolutions inside the block; the previous switches
    come back after it. The block must hold the forward and the backward:
    the explainer's backward runs after the forward has returned."""
    check_matmul_precision(precision)
    saved = _switches()
    _set_switches(PRECISION_SWITCHES[precision])
    try:
        yield
    finally:
        _set_switches(saved)


def highest_precision():
    """``matmul_precision_scope("highest")``: TF32 off for cuBLAS and cuDNN
    (cuDNN's default is TF32), bf16 GEMMs summed in float32."""
    return matmul_precision_scope("highest")
