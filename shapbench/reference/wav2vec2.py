"""Plain float32 Wav2Vec2 CTC (``transformers.Wav2Vec2ForCTC``, the
wav2vec2-base-960h layout): the conv feature encoder, the feature
projection, the grouped positional conv (its weight norm folded into the
weight; an even kernel drops the last frame), post-LN encoder layers
(``do_stable_layer_norm`` false) or pre-LN ones, and the CTC head."""

from __future__ import annotations

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
    merge_heads,
    norm_specs,
    split_heads,
)

__all__ = ["logits", "param_specs", "frames", "flops"]


def _layer(p, arch, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    heads, eps = arch["num_attention_heads"], arch["layer_norm_eps"]
    att = p["attention"]

    def attend(x):
        q, k, v = (split_heads(linear(att[n], x, prec), heads) for n in ("q", "k", "v"))
        return linear(att["out"], merge_heads(attention(q, k, v, None, prec)), prec)

    def ffn(x):
        return linear(p["ffn"]["output"], F.gelu(linear(p["ffn"]["intermediate"], x, prec)), prec)

    if arch["do_stable_layer_norm"]:
        h = h + attend(layer_norm(p["layer_norm"], h, eps))
        return h + ffn(layer_norm(p["final_layer_norm"], h, eps))
    h = layer_norm(p["layer_norm"], h + attend(h), eps)
    return layer_norm(p["final_layer_norm"], h + ffn(h), eps)


def logits(params, arch, x: torch.Tensor, prec: Precision = PLAIN) -> torch.Tensor:
    """Normalized waveforms [B, N] -> CTC logits [B, T, vocab], float32."""
    h = feature_projection(params["feature_projection"], arch,
                           conv_feature_encoder(params["feature_encoder"], arch, x, prec), prec)
    pc = params["encoder"]["pos_conv"]
    k = arch["num_conv_pos_embeddings"]
    pos = conv1d(h.transpose(1, 2), pc["kernel"], padding=k // 2,
                 groups=arch["num_conv_pos_embedding_groups"], prec=prec) + pc["bias"][:, None]
    if k % 2 == 0:
        pos = pos[..., :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    eps = arch["layer_norm_eps"]
    if not arch["do_stable_layer_norm"]:
        h = layer_norm(params["encoder"]["layer_norm"], h, eps)
    for p in params["encoder"]["layers"]:
        h = _layer(p, arch, h, prec)
    if arch["do_stable_layer_norm"]:
        h = layer_norm(params["encoder"]["layer_norm"], h, eps)
    return linear(params["lm_head"], h, prec)


def param_specs(arch):
    """(path, shape, std, mean) of every leaf, in the port's params tree."""
    h, f = arch["hidden_size"], arch["intermediate_size"]
    k, g = arch["num_conv_pos_embeddings"], arch["num_conv_pos_embedding_groups"]
    specs = conv_encoder_specs(arch)
    specs += [(("encoder", "pos_conv", "kernel"), (k, h // g, h), (4.0 / (k * h)) ** 0.5, 0.0),
              (("encoder", "pos_conv", "bias"), (h,), 0.02, 0.0)]
    specs += norm_specs(("encoder", "layer_norm"), h)
    for i in range(arch["num_hidden_layers"]):
        pre = ("encoder", "layers", i)
        for n in ("q", "k", "v", "out"):
            specs += linear_specs(pre + ("attention", n), h, h)
        specs += norm_specs(pre + ("layer_norm",), h)
        specs += linear_specs(pre + ("ffn", "intermediate"), h, f)
        specs += linear_specs(pre + ("ffn", "output"), f, h)
        specs += norm_specs(pre + ("final_layer_norm",), h)
    specs += linear_specs(("lm_head",), h, arch["vocab_size"])
    return specs


def flops(arch, n: int):
    """(forward, one input-gradient backward) FLOPs of one clip of n
    samples: 2 per multiply-add of every product. A product's input
    gradient costs what its forward does; attention's backward is twice
    its forward (dP, dQ, dK, dV against QK^T, PV); no weight gradients."""
    from shapbench.costs import conv_encoder_flops

    t = frames(arch, n)
    h, f, v = arch["hidden_size"], arch["intermediate_size"], arch["vocab_size"]
    k, g = arch["num_conv_pos_embeddings"], arch["num_conv_pos_embedding_groups"]
    conv = conv_encoder_flops(arch, n)
    dense = 2.0 * t * (arch["conv_dim"][-1] * h + k * (h // g) * h + h * v)
    layer = 2.0 * t * (4 * h * h + 2 * h * f)
    attn = 4.0 * t * t * h
    n_l = arch["num_hidden_layers"]
    fwd = conv + dense + n_l * (layer + attn)
    return fwd, conv + dense + n_l * (layer + 2 * attn)
