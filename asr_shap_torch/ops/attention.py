"""Multi-head attention dispatch: the plain PyTorch math or the flash
kernels (K2-K4)."""

from __future__ import annotations

import torch

from asr_shap_torch.kernels.flash_attention import flash_attention


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor | None) -> torch.Tensor:
    """q, k, v [B, H, T, D]; bias additive [B, 1, 1, T] or [B, H, T, T].
    The softmax runs in float32."""
    scale = q.shape[-1] ** -0.5
    scores = (q * scale) @ k.transpose(-1, -2)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    return probs @ v


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None = None,
                         impl: str = "xla") -> torch.Tensor:
    """Scaled dot-product attention over [B, H, T, D] tensors.

    impl: "xla" (plain math), "pallas" (the flash kernels) or "auto"
    (resolves to "xla"). Gradient contract for ``bias``: on the kernel path
    a [B, 1, 1, T] bias is a constant mask with a zero cotangent; the plain
    path propagates real gradients. Under "pallas" a bias that is not
    rank 4 raises: the kernels take no other layout.
    """
    if impl == "auto":
        impl = "xla"
    if impl == "pallas":
        if bias is not None and bias.ndim != 4:
            raise NotImplementedError(
                f"flash attention takes a [B, 1, 1, T] bias, got {tuple(bias.shape)}")
        return flash_attention(q, k, v, bias)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _xla_attention(q, k, v, bias)
