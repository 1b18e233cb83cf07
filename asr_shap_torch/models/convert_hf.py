"""HuggingFace Wav2Vec2ForCTC and Wav2Vec2ConformerForCTC checkpoints as
port params.

The port of ``asr_shap/models/convert_hf.py``: a torch ``state_dict`` is
mapped onto the params tree of ``models/wav2vec2.py`` or
``models/w2v2_conformer.py`` (one dict per encoder layer, float32 on the
device asked for). The weight-normed positional conv of Wav2Vec2 is folded
to its effective weight, from either layout: the legacy
``weight_g``/``weight_v`` or the parametrized
``parametrizations.weight.original{0,1}``. ``load_pretrained`` and
``load_pretrained_conformer`` read a checkpoint by local path or hub name
through ``transformers``, imported when called: without it they raise
ImportError before any work.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from asr_shap_torch.core.config import Wav2Vec2Config, Wav2Vec2ConformerConfig
from asr_shap_torch.core.device import resolve_device
from asr_shap_torch.core.params_io import StateDictReader

Params = Dict[str, Any]


def _conv_layers(r: StateDictReader, root: str, n: int) -> list:
    """The conv feature encoder: each conv and its norm, where it has one."""
    layers = []
    for i in range(n):
        pre = f"{root}.feature_extractor.conv_layers.{i}"
        layer: Params = {"conv": r.conv1d(f"{pre}.conv")}
        if f"{pre}.layer_norm.weight" in r.sd:
            layer["norm"] = r.norm(f"{pre}.layer_norm")
        layers.append(layer)
    return layers


def _weight_normed_conv(r: StateDictReader, prefix: str) -> np.ndarray:
    """The effective weight of a torch weight_norm(dim=2) conv, torch layout
    [out, in/groups, K]: g * v / |v|, the norm over every axis where g has
    size 1."""
    if f"{prefix}.weight_g" in r.sd:
        g, v = r.array(f"{prefix}.weight_g"), r.array(f"{prefix}.weight_v")
    elif f"{prefix}.parametrizations.weight.original0" in r.sd:
        g = r.array(f"{prefix}.parametrizations.weight.original0")
        v = r.array(f"{prefix}.parametrizations.weight.original1")
    else:
        return r.array(f"{prefix}.weight")
    norm_dims = tuple(i for i, s in enumerate(g.shape) if s == 1)
    return g * v / np.sqrt(np.sum(v ** 2, axis=norm_dims, keepdims=True))


def convert_wav2vec2_state_dict(sd: Mapping[str, Any], config: Wav2Vec2Config,
                                device: str | torch.device = "cuda") -> Params:
    """Wav2Vec2ForCTC state_dict -> port params."""
    cfg = config
    r = StateDictReader(sd, resolve_device(device))
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"wav2vec2.encoder.layers.{i}"
        layers.append({
            "attention": {name: r.linear(f"{pre}.attention.{name}_proj")
                          for name in ("q", "k", "v", "out")},
            "layer_norm": r.norm(f"{pre}.layer_norm"),
            "ffn": {"intermediate": r.linear(f"{pre}.feed_forward.intermediate_dense"),
                    "output": r.linear(f"{pre}.feed_forward.output_dense")},
            "final_layer_norm": r.norm(f"{pre}.final_layer_norm"),
        })
    pos_w = _weight_normed_conv(r, "wav2vec2.encoder.pos_conv_embed.conv")
    return {
        "feature_encoder": _conv_layers(r, "wav2vec2", len(cfg.conv_dim)),
        "feature_projection": {
            "layer_norm": r.norm("wav2vec2.feature_projection.layer_norm"),
            "projection": r.linear("wav2vec2.feature_projection.projection"),
        },
        "encoder": {
            "pos_conv": {"kernel": r.tensor(pos_w.transpose(2, 1, 0)),  # [K, in/g, out]
                         "bias": r.get("wav2vec2.encoder.pos_conv_embed.conv.bias")},
            "layer_norm": r.norm("wav2vec2.encoder.layer_norm"),
            "layers": layers,
        },
        "lm_head": r.linear("lm_head"),
    }


def convert_wav2vec2_conformer_state_dict(sd: Mapping[str, Any],
                                          config: Wav2Vec2ConformerConfig,
                                          device: str | torch.device = "cuda") -> Params:
    """Wav2Vec2ConformerForCTC state_dict -> port params. HF builds a conv
    positional embedding in the encoder and never applies it, so its weights
    are dropped, as is ``masked_spec_embed`` (SpecAugment, training only)."""
    cfg = config
    r = StateDictReader(sd, resolve_device(device))
    root = "wav2vec2_conformer"

    def ffn(pre):
        return {"norm": r.norm(f"{pre}_layer_norm"),
                "intermediate": r.linear(f"{pre}.intermediate_dense"),
                "output": r.linear(f"{pre}.output_dense")}

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"{root}.encoder.layers.{i}"
        cm = f"{pre}.conv_module"
        attn: Params = {"norm": r.norm(f"{pre}.self_attn_layer_norm"),
                        **{name: r.linear(f"{pre}.self_attn.linear_{name}")
                           for name in ("q", "k", "v", "out")}}
        if cfg.position_embeddings_type == "relative":
            attn["pos"] = r.linear(f"{pre}.self_attn.linear_pos")
            attn["bias_u"] = r.get(f"{pre}.self_attn.pos_bias_u")
            attn["bias_v"] = r.get(f"{pre}.self_attn.pos_bias_v")
        layers.append({
            "ffn1": ffn(f"{pre}.ffn1"),
            "attn": attn,
            "conv": {
                "norm": r.norm(f"{cm}.layer_norm"),
                "pw1": r.pointwise(f"{cm}.pointwise_conv1"),
                "depthwise": r.conv1d(f"{cm}.depthwise_conv"),
                "bn": {"scale": r.get(f"{cm}.batch_norm.weight"),
                       "bias": r.get(f"{cm}.batch_norm.bias"),
                       "mean": r.get(f"{cm}.batch_norm.running_mean"),
                       "var": r.get(f"{cm}.batch_norm.running_var")},
                "pw2": r.pointwise(f"{cm}.pointwise_conv2"),
            },
            "ffn2": ffn(f"{pre}.ffn2"),
            "final_norm": r.norm(f"{pre}.final_layer_norm"),
        })
    return {
        "feature_encoder": _conv_layers(r, root, len(cfg.conv_dim)),
        "feature_projection": {
            "layer_norm": r.norm(f"{root}.feature_projection.layer_norm"),
            "projection": r.linear(f"{root}.feature_projection.projection"),
        },
        "encoder": {"layers": layers, "layer_norm": r.norm(f"{root}.encoder.layer_norm")},
        "lm_head": r.linear("lm_head"),
    }


def load_pretrained_conformer(model_name_or_path: str,
                              config: Optional[Wav2Vec2ConformerConfig] = None,
                              device: str | torch.device = "cuda"):
    """An HF Wav2Vec2ConformerForCTC checkpoint (local path or hub name) ->
    (params on ``device``, config)."""
    from transformers import Wav2Vec2ConformerForCTC

    device = resolve_device(device)
    model = Wav2Vec2ConformerForCTC.from_pretrained(model_name_or_path)
    hf = model.config
    if config is None:
        config = Wav2Vec2ConformerConfig(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            conv_dim=tuple(hf.conv_dim),
            conv_stride=tuple(hf.conv_stride),
            conv_kernel=tuple(hf.conv_kernel),
            conv_bias=hf.conv_bias,
            feat_extract_norm=hf.feat_extract_norm,
            layer_norm_eps=hf.layer_norm_eps,
            feat_proj_dim=hf.conv_dim[-1],
            position_embeddings_type=hf.position_embeddings_type,
            rotary_embedding_base=getattr(hf, "rotary_embedding_base", 10_000),
            conv_depthwise_kernel_size=hf.conv_depthwise_kernel_size,
            hidden_act=hf.hidden_act,
        )
    return convert_wav2vec2_conformer_state_dict(model.state_dict(), config, device), config


def load_pretrained(model_name_or_path: str, config: Optional[Wav2Vec2Config] = None,
                    device: str | torch.device = "cuda"):
    """An HF Wav2Vec2ForCTC checkpoint (local path or hub name) -> (params
    on ``device``, config)."""
    from transformers import Wav2Vec2ForCTC

    device = resolve_device(device)
    model = Wav2Vec2ForCTC.from_pretrained(model_name_or_path)
    hf = model.config
    if config is None:
        config = Wav2Vec2Config(
            vocab_size=hf.vocab_size,
            hidden_size=hf.hidden_size,
            num_hidden_layers=hf.num_hidden_layers,
            num_attention_heads=hf.num_attention_heads,
            intermediate_size=hf.intermediate_size,
            conv_dim=tuple(hf.conv_dim),
            conv_stride=tuple(hf.conv_stride),
            conv_kernel=tuple(hf.conv_kernel),
            conv_bias=hf.conv_bias,
            feat_extract_norm=hf.feat_extract_norm,
            num_conv_pos_embeddings=hf.num_conv_pos_embeddings,
            num_conv_pos_embedding_groups=hf.num_conv_pos_embedding_groups,
            do_stable_layer_norm=hf.do_stable_layer_norm,
            layer_norm_eps=hf.layer_norm_eps,
            feat_proj_dim=hf.conv_dim[-1],
        )
    return convert_wav2vec2_state_dict(model.state_dict(), config, device), config
