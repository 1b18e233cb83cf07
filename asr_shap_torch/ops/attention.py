"""Multi-head attention dispatch: the plain PyTorch math or the flash
kernels (K2-K4, and K2f/K3b/K4f for a full score bias); and the
Transformer-XL relative-position pieces of the rel-pos conformers."""

from __future__ import annotations

import math

import torch

from asr_shap_torch.kernels.flash_attention import flash_attention


def rel_pos_embedding(t: int, d: int,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """Transformer-XL sinusoidal relative-position table [2T-1, d], float32:
    row i encodes relative position (T-1-i), positives (keys to the left)
    first."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10_000.0) / d))[None, :]
    pe_pos = torch.zeros((t, d), device=device)
    pe_pos[:, 0::2] = torch.sin(pos * div)
    pe_pos[:, 1::2] = torch.cos(pos * div)
    pe_neg = torch.zeros((t, d), device=device)
    pe_neg[:, 0::2] = torch.sin(-pos * div)
    pe_neg[:, 1::2] = torch.cos(-pos * div)
    return torch.cat([pe_pos.flip(0), pe_neg[1:]], dim=0)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, 2T-1] raw (query, rel-embedding) scores -> [B, H, T, T]
    aligned (query, key) scores, via the zero-pad/reshape shift trick."""
    b, h, t, r = x.shape
    x = torch.cat([x.new_zeros((b, h, t, 1)), x], dim=-1)
    x = x.reshape(b, h, r + 1, t)[:, :, 1:].reshape(b, h, t, r)
    return x[..., : r // 2 + 1]


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
    (resolves to "xla"). Gradient contract for ``bias``: a rank-4 bias
    broadcastable to [B, H, T, T] is differentiable on both paths, except
    that on the kernel path a [B, 1, 1, T] bias is a constant mask with a
    zero cotangent; the plain path propagates real gradients there. Under
    "pallas" a bias that is not rank 4 raises: the kernels take no other
    layout (the reference sends it to its XLA math instead).
    """
    if impl == "auto":
        impl = "xla"
    if impl == "pallas":
        if bias is not None and bias.ndim != 4:
            raise NotImplementedError(
                f"flash attention takes a rank-4 bias, got {tuple(bias.shape)}")
        return flash_attention(q, k, v, bias)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _xla_attention(q, k, v, bias)
