"""Plain float32 building blocks of the reference models, written from the
published layer equations (``transformers``' Wav2Vec2 and
Wav2Vec2-Conformer), with an optional lower ``Precision`` for the control.

Layouts follow the params tree the benchmark makes (``shapbench.params``):
linears ``kernel [in, out]``, convs ``kernel [K, C_in // groups, C_out]``;
activations are ``[B, T, C]`` except inside the conv feature encoder."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 11 significant bits (Veltkamp's split: the
    high part of x at 2^13 + 1), in float32 arithmetic."""
    c = x * 8193.0
    return c - (c - x)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax at 448)."""
    s = (x.detach().abs().amax() / 448.0).clamp(min=1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


ROUNDERS = {"tf32": _tf32, "fp8": _fp8}


class _RoundGrad(torch.autograd.Function):
    """Identity forward; rounds the incoming gradient, so that the
    backward's products also take rounded operands."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, rounder):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.rounder = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.rounder(g), None


class Precision:
    """Where a product's operands are rounded: None (plain float32) or a
    name of ``ROUNDERS``. ``operand`` rounds in the forward and lets the
    gradient through; ``output`` rounds the gradient that reaches the
    product from above."""

    def __init__(self, name: Optional[str] = None):
        if name is not None and name not in ROUNDERS:
            raise ValueError(f"unknown precision {name!r}: one of {sorted(ROUNDERS)}")
        self.name = name
        self._round: Optional[Callable] = ROUNDERS.get(name)

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self._round is None:
            return x
        return x + (self._round(x) - x).detach()

    def output(self, y: torch.Tensor) -> torch.Tensor:
        if self._round is None:
            return y
        return _RoundGrad.apply(y, self._round)


PLAIN = Precision()


def matmul(a: torch.Tensor, b: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    return prec.output(prec.operand(a) @ prec.operand(b))


def linear(p, x: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    y = matmul(x, p["kernel"], prec)
    return y + p["bias"] if "bias" in p else y


def conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1, prec: Precision = PLAIN) -> torch.Tensor:
    """x [B, C_in, T] (channels first), kernel [K, C_in // groups, C_out]."""
    w = kernel.permute(2, 1, 0)
    return prec.output(F.conv1d(prec.operand(x), prec.operand(w), stride=stride,
                                padding=padding, groups=groups))


def layer_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              score_bias: Optional[torch.Tensor], prec: Precision = PLAIN) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + score_bias) v over [B, H, T, d]."""
    scores = matmul(q, k.transpose(-1, -2), prec) * q.shape[-1] ** -0.5
    if score_bias is not None:
        scores = scores + score_bias
    return matmul(torch.softmax(scores, dim=-1), v, prec)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def conv_feature_encoder(layers, arch, x: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    """Raw waveform [B, N] -> features [B, T, C]: each strided conv, then
    GroupNorm with one group per channel on the first layer ("group") or a
    LayerNorm over the channels on every layer ("layer"), then GELU."""
    h = x[:, None, :]
    for i, layer in enumerate(layers):
        h = conv1d(h, layer["conv"]["kernel"], stride=arch["conv_stride"][i], prec=prec)
        if "bias" in layer["conv"]:
            h = h + layer["conv"]["bias"][:, None]
        if arch["feat_extract_norm"] == "group" and i == 0:
            h = F.group_norm(h, h.shape[1], layer["norm"]["scale"], layer["norm"]["bias"],
                             arch["layer_norm_eps"])
        elif arch["feat_extract_norm"] == "layer":
            h = layer_norm(layer["norm"], h.transpose(1, 2), arch["layer_norm_eps"]).transpose(1, 2)
        h = F.gelu(h)
    return h.transpose(1, 2)


def feature_projection(p, arch, feats: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    return linear(p["projection"], layer_norm(p["layer_norm"], feats, arch["layer_norm_eps"]), prec)


def frames(arch, n: int) -> int:
    """Output frames of the conv feature encoder for n samples."""
    for k, s in zip(arch["conv_kernel"], arch["conv_stride"]):
        n = (n - k) // s + 1
    return n


def conv_encoder_specs(arch):
    """(path, shape, std, mean) of the conv feature encoder's and the
    feature projection's leaves."""
    specs = []
    c_in = 1
    for i, (c, k) in enumerate(zip(arch["conv_dim"], arch["conv_kernel"])):
        pre = ("feature_encoder", i)
        specs.append((pre + ("conv", "kernel"), (k, c_in, c), (2.0 / (k * c_in)) ** 0.5, 0.0))
        if arch["conv_bias"]:
            specs.append((pre + ("conv", "bias"), (c,), 0.02, 0.0))
        if (arch["feat_extract_norm"] == "group" and i == 0) or arch["feat_extract_norm"] == "layer":
            specs += norm_specs(pre + ("norm",), c)
        c_in = c
    fp = arch["conv_dim"][-1]
    specs += norm_specs(("feature_projection", "layer_norm"), fp)
    specs += linear_specs(("feature_projection", "projection"), fp, arch["hidden_size"])
    return specs


def norm_specs(path, dim):
    return [(path + ("scale",), (dim,), 0.1, 1.0), (path + ("bias",), (dim,), 0.02, 0.0)]


def linear_specs(path, d_in, d_out, bias=True):
    specs = [(path + ("kernel",), (d_in, d_out), d_in ** -0.5, 0.0)]
    if bias:
        specs.append((path + ("bias",), (d_out,), 0.02, 0.0))
    return specs
