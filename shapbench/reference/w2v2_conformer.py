"""Plain float32 Wav2Vec2-Conformer CTC (``transformers.
Wav2Vec2ConformerForCTC``, the wav2vec2-conformer-rel-pos-large layout):
the conv feature encoder and projection, then conformer blocks (half-step
FFN, self-attention with Transformer-XL relative positions, the
convolution module with inference BatchNorm, half-step FFN, LayerNorm),
the encoder's LayerNorm and the CTC head. No positional conv is applied.

Relative positions: row r of the sinusoidal table is position T - 1 - r;
the score of query i and key j adds (q_i + v) . W_pos pe[T - 1 - i + j],
gathered here by index (the published form shifts by a pad and reshape),
and the content score uses q + u."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from shapbench.reference.common import (
    PLAIN,
    Precision,
    attention,
    conv1d,
    conv_encoder_specs,
    conv_feature_encoder,
    feature_projection,
    frames,
    layer_norm,
    linear,
    linear_specs,
    matmul,
    merge_heads,
    norm_specs,
    split_heads,
)

__all__ = ["logits", "param_specs", "frames", "flops"]


def position_table(t: int, d: int, device) -> torch.Tensor:
    """[2T - 1, d]: sin and cos of position (T - 1 - r) at frequencies
    10000^(-2j/d), interleaved."""
    pos = (t - 1 - torch.arange(2 * t - 1, device=device, dtype=torch.float64))[:, None]
    freq = torch.exp(torch.arange(0, d, 2, device=device, dtype=torch.float64)
                     * (-math.log(10_000.0) / d))[None, :]
    pe = torch.stack([torch.sin(pos * freq), torch.cos(pos * freq)], dim=-1)
    return pe.reshape(2 * t - 1, d).to(torch.float32)


def _swish(x):
    return x * torch.sigmoid(x)


def _ffn(p, arch, x, prec):
    act = _swish if arch["hidden_act"] in ("swish", "silu") else F.gelu
    h = linear(p["intermediate"], layer_norm(p["norm"], x, arch["layer_norm_eps"]), prec)
    return linear(p["output"], act(h), prec)


def _attention(p, arch, x, pe, prec):
    heads = arch["num_attention_heads"]
    xn = layer_norm(p["norm"], x, arch["layer_norm_eps"])
    q, k, v = (split_heads(linear(p[n], xn, prec), heads) for n in ("q", "k", "v"))
    bias = None
    if arch["position_embeddings_type"] == "relative":
        t, hd = x.shape[1], q.shape[-1]
        pos = matmul(pe, p["pos"]["kernel"], prec).reshape(2 * t - 1, heads, hd)
        raw = matmul(q + p["bias_v"][None, :, None, :], pos.permute(1, 2, 0), prec)
        i = torch.arange(t, device=x.device)
        idx = (t - 1 - i[:, None] + i[None, :]).expand(*raw.shape[:-1], t)
        bias = torch.gather(raw, -1, idx) * hd ** -0.5
        q = q + p["bias_u"][None, :, None, :]
    elif arch["position_embeddings_type"] != "none":
        raise NotImplementedError(f"positions {arch['position_embeddings_type']!r}")
    return linear(p["out"], merge_heads(attention(q, k, v, bias, prec)), prec)


def _conv_module(p, arch, x, prec):
    h = linear(p["pw1"], layer_norm(p["norm"], x, arch["layer_norm_eps"]), prec)
    h = F.glu(h, dim=-1)
    ksz = arch["conv_depthwise_kernel_size"]
    h = conv1d(h.transpose(1, 2), p["depthwise"]["kernel"], padding=(ksz - 1) // 2,
               groups=h.shape[-1], prec=prec).transpose(1, 2)
    bn = p["bn"]
    h = (h - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]
    return linear(p["pw2"], _swish(h), prec)


def _block(p, arch, x, pe, prec):
    x = x + 0.5 * _ffn(p["ffn1"], arch, x, prec)
    x = x + _attention(p["attn"], arch, x, pe, prec)
    x = x + _conv_module(p["conv"], arch, x, prec)
    x = x + 0.5 * _ffn(p["ffn2"], arch, x, prec)
    return layer_norm(p["final_norm"], x, arch["layer_norm_eps"])


def logits(params, arch, x: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    """Normalized waveforms [B, N] -> CTC logits [B, T, vocab], float32."""
    h = feature_projection(params["feature_projection"], arch,
                           conv_feature_encoder(params["feature_encoder"], arch, x, prec), prec)
    pe = position_table(h.shape[1], arch["hidden_size"], h.device)
    for p in params["encoder"]["layers"]:
        h = _block(p, arch, h, pe, prec)
    h = layer_norm(params["encoder"]["layer_norm"], h, arch["layer_norm_eps"])
    return linear(params["lm_head"], h, prec)


def param_specs(arch):
    """(path, shape, std, mean) of every leaf, in the port's params tree."""
    d, f = arch["hidden_size"], arch["intermediate_size"]
    heads = arch["num_attention_heads"]
    ksz = arch["conv_depthwise_kernel_size"]
    specs = conv_encoder_specs(arch)
    for i in range(arch["num_hidden_layers"]):
        pre = ("encoder", "layers", i)
        for ffn in ("ffn1", "ffn2"):
            specs += norm_specs(pre + (ffn, "norm"), d)
            specs += linear_specs(pre + (ffn, "intermediate"), d, f)
            specs += linear_specs(pre + (ffn, "output"), f, d)
        specs += norm_specs(pre + ("attn", "norm"), d)
        for n in ("q", "k", "v", "out"):
            specs += linear_specs(pre + ("attn", n), d, d)
        if arch["position_embeddings_type"] == "relative":
            specs += linear_specs(pre + ("attn", "pos"), d, d, bias=False)
            specs += [(pre + ("attn", "bias_u"), (heads, d // heads), 0.02, 0.0),
                      (pre + ("attn", "bias_v"), (heads, d // heads), 0.02, 0.0)]
        specs += norm_specs(pre + ("conv", "norm"), d)
        specs += linear_specs(pre + ("conv", "pw1"), d, 2 * d, bias=False)
        specs += [(pre + ("conv", "depthwise", "kernel"), (ksz, 1, d), ksz ** -0.5, 0.0),
                  (pre + ("conv", "bn", "scale"), (d,), 0.1, 1.0),
                  (pre + ("conv", "bn", "bias"), (d,), 0.02, 0.0),
                  (pre + ("conv", "bn", "mean"), (d,), 0.02, 0.0),
                  (pre + ("conv", "bn", "var"), (d,), 0.1, 1.0)]
        specs += linear_specs(pre + ("conv", "pw2"), d, d, bias=False)
        specs += norm_specs(pre + ("final_norm",), d)
    specs += norm_specs(("encoder", "layer_norm"), d)
    specs += linear_specs(("lm_head",), d, arch["vocab_size"])
    return specs


def flops(arch, n: int):
    """(forward, one input-gradient backward) FLOPs of one clip of n
    samples, counted as ``wav2vec2.flops`` does. The position projection
    of the table does not depend on the input: forward only."""
    from shapbench.costs import conv_encoder_flops

    t = frames(arch, n)
    d, f, v = arch["hidden_size"], arch["intermediate_size"], arch["vocab_size"]
    ksz = arch["conv_depthwise_kernel_size"]
    conv = conv_encoder_flops(arch, n)
    dense = 2.0 * t * (arch["conv_dim"][-1] * d + d * v)
    layer = 2.0 * t * (2 * 2 * d * f + 4 * d * d + 2 * d * d + d * d + ksz * d)
    attn = 4.0 * t * t * d
    rel = 0.0
    if arch["position_embeddings_type"] == "relative":
        rel = 2.0 * t * (2 * t - 1) * d          # (q + v) . W_pos pe
        pos_proj = 2.0 * (2 * t - 1) * d * d      # W_pos pe, input-independent
    else:
        pos_proj = 0.0
    n_l = arch["num_hidden_layers"]
    fwd = conv + dense + n_l * (layer + attn + rel + pos_proj)
    return fwd, conv + dense + n_l * (layer + 2 * attn + rel)
