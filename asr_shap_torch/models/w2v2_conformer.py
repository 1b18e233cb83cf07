"""Wav2Vec2-Conformer CTC model, functional, on a params dict of tensors.

The port of ``asr_shap/models/w2v2_conformer.py``
(``transformers.Wav2Vec2ConformerForCTC``): conformer blocks over the
wav2vec2 conv feature encoder and feature projection, which come from
``models/wav2vec2.py``. Position schemes:

  * "relative": Transformer-XL relative-position attention. The
    content-position scores (q + bias_v) . proj(pe), rel-shifted and
    pre-scaled by hd^-1/2, enter the attention as a differentiable
    [B, H, T, T] score bias; under ``attention_impl="pallas"`` that is the
    full-bias flash kernels (K2f forward, K3b dq with d(bias), K4f dk/dv);
  * "rotary": rotary embedding of the pre-projection hidden states (the
    HF formulation rotates the shared q/k input; parity requires it);
  * "none".

As in HF, the encoder has no conv positional embedding (HF builds one and
never applies it), and BatchNorm runs in inference mode. The conv module
does not re-mask padded frames, as HF does not. The params tree is the
reference's with one dict per encoder layer (see ``core/params_io.py``).

``dtype="bfloat16"`` runs the reference's bf16 forward: params and input
cast to bf16, the position table, the mask and the rel-pos score bias in
bf16 (the flash kernels take the bias as float32 and return its gradient
in the bias's dtype, as the reference's), BatchNorm with its bf16
statistics, float32 layer-norm statistics and logits. Rotary positions
have no bf16 path in the reference, and raise here too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from asr_shap_torch.core.config import Wav2Vec2ConformerConfig
from asr_shap_torch.core.device import resolve_device
from asr_shap_torch.models.conformer import PLAIN_RULES, Rules
from asr_shap_torch.models.wav2vec2 import (
    ParamInit,
    _conv1d,
    _gelu,
    _layer_norm,
    _linear,
    cast_params_for_compute,
    compute_dtype,
    frame_mask_for,
    init_conv_encoder,
    projected_features,
)
from asr_shap_torch.ops.attention import multi_head_attention, rel_pos_embedding, rel_shift
from asr_shap_torch.ops.remat import checkpoint_layer
from asr_shap_torch.parallel.tp import copy_to_tp, gather_last, row_linear, scatter_last

Params = Dict[str, Any]


# --------------------------------------------------------------------- init

def init_w2v2_conformer_params(seed: int, config: Wav2Vec2ConformerConfig,
                               device: str | torch.device = "cuda") -> Params:
    """Random initialization from a numpy seed with the reference's shapes
    (``ParamInit``'s scheme; u/v biases zero, BatchNorm at identity
    statistics)."""
    init = ParamInit(np.random.default_rng(seed), resolve_device(device))
    cfg = config
    d, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    zeros = lambda *shape: init.tensor(np.zeros(shape))

    def ffn():
        return {"norm": init.norm(d),
                "intermediate": init.linear(d, cfg.intermediate_size),
                "output": init.linear(cfg.intermediate_size, d)}

    def layer():
        attn: Params = {"norm": init.norm(d),
                        **{name: init.linear(d, d) for name in ("q", "k", "v", "out")}}
        if cfg.position_embeddings_type == "relative":
            attn["pos"] = init.linear(d, d, bias=False)
            attn["bias_u"] = zeros(nh, hd)
            attn["bias_v"] = zeros(nh, hd)
        ksz = cfg.conv_depthwise_kernel_size
        return {
            "ffn1": ffn(),
            "attn": attn,
            "conv": {
                "norm": init.norm(d),
                "pw1": init.linear(d, 2 * d, bias=False),
                "depthwise": {"kernel": init.normal((ksz, 1, d), math.sqrt(1.0 / ksz))},
                "bn": {"scale": init.tensor(np.ones(d)), "bias": zeros(d),
                       "mean": zeros(d), "var": init.tensor(np.ones(d))},
                "pw2": init.linear(d, d, bias=False),
            },
            "ffn2": ffn(),
            "final_norm": init.norm(d),
        }

    return {
        "feature_encoder": init_conv_encoder(init, cfg),
        "feature_projection": {"layer_norm": init.norm(cfg.feat_proj_dim),
                               "projection": init.linear(cfg.feat_proj_dim, d)},
        "encoder": {"layers": [layer() for _ in range(cfg.num_hidden_layers)],
                    "layer_norm": init.norm(d)},
        "lm_head": init.linear(d, cfg.vocab_size),
    }


# ------------------------------------------------------------------ forward

def _apply_rotary(h: torch.Tensor, nh: int, hd: int, base: float) -> torch.Tensor:
    """Rotary embedding on pre-projection hidden states [B, T, D]."""
    b, t, d = h.shape
    inv = 1.0 / (base ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=h.device) / hd))
    freqs = torch.arange(t, dtype=torch.float32, device=h.device)[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)                  # [T, hd]
    cos = torch.cos(emb)[None, :, None, :]
    sin = torch.sin(emb)[None, :, None, :]
    hs = h.reshape(b, t, nh, hd)
    h1, h2 = hs[..., : hd // 2], hs[..., hd // 2:]
    rot = torch.cat([-h2, h1], dim=-1)
    return (hs * cos + rot * sin).reshape(b, t, d)


def _ffn(p: Params, x: torch.Tensor, act, eps: float, tp=None) -> torch.Tensor:
    h = _linear(p["intermediate"], copy_to_tp(_layer_norm(p["norm"], x, eps), tp))
    return row_linear(p["output"], act(h), tp)


def _attention(p: Params, cfg: Wav2Vec2ConformerConfig, x: torch.Tensor,
               pe: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               tp=None) -> torch.Tensor:
    """Self-attention; under a tensor-parallel mesh ``tp``, over this rank's
    heads (the count from the q projection's width), with this rank's rows
    of the replicated position projection and u/v biases."""
    b, t, _ = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    nh_local = p["q"]["kernel"].shape[-1] // hd
    xn = copy_to_tp(_layer_norm(p["norm"], x, cfg.layer_norm_eps), tp)
    qk_in = xn
    if cfg.position_embeddings_type == "rotary":
        qk_in = _apply_rotary(xn, nh, hd, float(cfg.rotary_embedding_base))

    def proj(pp, v):
        return _linear(pp, v).reshape(b, t, nh_local, hd).transpose(1, 2)

    q, k, v = proj(p["q"], qk_in), proj(p["k"], qk_in), proj(p["v"], xn)
    attn_bias, q_attn = bias, q
    if cfg.position_embeddings_type == "relative":
        # content-position scores, pre-scaled so that they add to the
        # attention's already scaled q.k: (ac + bd) / sqrt(hd) overall
        p_proj = _linear(p["pos"], pe).reshape(-1, nh, hd)      # [2T-1, H, hd]
        bias_u, bias_v = p["bias_u"], p["bias_v"]
        if tp is not None:  # this rank's heads of the replicated tensors
            rows = slice(tp.model_rank * nh_local, (tp.model_rank + 1) * nh_local)
            p_proj, bias_u, bias_v = (copy_to_tp(t, tp)[..., rows, :]
                                      for t in (p_proj, bias_u, bias_v))
        q_v = q + bias_v[None, :, None, :]
        scores_bd = torch.einsum("bhtd,rhd->bhtr", q_v, p_proj)
        rel = rel_shift(scores_bd) * hd ** -0.5                  # [B, H, T, T]
        attn_bias = rel if bias is None else rel + bias
        q_attn = q + bias_u[None, :, None, :]
    o = multi_head_attention(q_attn, k, v, attn_bias, impl=cfg.attention_impl)
    return row_linear(p["out"], o.transpose(1, 2).reshape(b, t, nh_local * hd), tp)


def _conv_module(p: Params, cfg: Wav2Vec2ConformerConfig, x: torch.Tensor,
                 rules: Rules, tp=None) -> torch.Tensor:
    """LN, pointwise conv, GLU, depthwise conv (a library conv, as in the
    reference; in bf16 on float32 copies, see ``wav2vec2._conv1d``),
    inference BatchNorm, SiLU, pointwise conv (GLU and SiLU from ``rules``).
    Under a tensor-parallel mesh the GLU and the depthwise conv take the
    gathered width of the column-parallel pw1, and pw2 this rank's input
    block."""
    h = _linear(p["pw1"], copy_to_tp(_layer_norm(p["norm"], x, cfg.layer_norm_eps), tp))
    if tp is not None:
        h = gather_last(h, tp)
    h = rules.glu(h, -1)                                        # [B, T, d]
    ksz = cfg.conv_depthwise_kernel_size
    h = _conv1d(h, p["depthwise"]["kernel"], padding=(ksz - 1) // 2, groups=h.shape[-1])
    bn = p["bn"]
    h = (h - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5) * bn["scale"] + bn["bias"]
    h = rules.silu(h)
    if tp is not None:
        h = scatter_last(h, tp)
    return row_linear(p["pw2"], h, tp)


def _conformer_block(layer: Params, cfg: Wav2Vec2ConformerConfig, x: torch.Tensor,
                     pe: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                     rules: Rules, gelu, tp=None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    act = rules.silu if cfg.hidden_act in ("swish", "silu") else gelu
    x = x + 0.5 * _ffn(layer["ffn1"], x, act, eps, tp)
    x = x + _attention(layer["attn"], cfg, x, pe, bias, tp)
    x = x + _conv_module(layer["conv"], cfg, x, rules, tp)
    x = x + 0.5 * _ffn(layer["ffn2"], x, act, eps, tp)
    return _layer_norm(layer["final_norm"], x, eps)


def w2v2_conformer_logits(params: Params, config: Wav2Vec2ConformerConfig,
                          input_values: torch.Tensor,
                          lengths: Optional[torch.Tensor] = None,
                          remat: bool = False, rules: Rules = PLAIN_RULES,
                          gelu=_gelu, tp=None) -> torch.Tensor:
    """Normalized waveform [B, N] -> CTC logits [B, T_frames, vocab], float32.
    ``lengths`` enables padded batching; ``remat`` recomputes each conformer
    block in the backward under ``config.remat_policy`` (see
    ``wav2vec2.encoder``; the reference's policy is always "full" here, and
    both give the same values). ``rules`` and
    ``gelu`` plug in the blocks' SiLU/GLU and every GELU (DeepSHAP passes
    ``conformer.deepshap_rules()`` and ``explain.deepshap.gelu_rescale``, the
    batch axis carrying the (actual, reference) pair). ``tp`` is the
    tensor-parallel mesh of params sharded by ``parallel.tp.shard_params_tp``,
    or None. ``config.dtype=
    "bfloat16"`` casts params (a no-op for leaves already bf16) and input.
    Raises where ``wav2vec2_logits`` does (an unknown ``matmul_precision``
    or dtype, CUDA outside its precision scope), and on rotary positions in
    bf16, as the reference does."""
    cfg = config
    dtype = compute_dtype(cfg.dtype)
    if dtype != torch.float32 and cfg.position_embeddings_type == "rotary":
        raise NotImplementedError(
            "rotary positions in bfloat16: the reference has no such path (its float32 "
            "cos and sin promote q and k to float32, and its depthwise conv then refuses "
            "a float32 input with a bf16 kernel)")
    params = cast_params_for_compute(params, cfg.dtype)
    h = projected_features(params, cfg, input_values.to(dtype), gelu)
    bias = None
    if lengths is not None:
        frame_mask = frame_mask_for(cfg, lengths, h)
        h = h * frame_mask[..., None]
        bias = torch.where(frame_mask[:, None, None, :] != 0, 0.0, -1e9).to(h.dtype)
    pe = None
    if cfg.position_embeddings_type == "relative":
        pe = rel_pos_embedding(h.shape[1], cfg.hidden_size, device=h.device).to(h.dtype)

    def block(x, pe_, bias_, layer):
        return _conformer_block(layer, cfg, x, pe_, bias_, rules, gelu, tp)

    for layer in params["encoder"]["layers"]:
        if remat:
            h = checkpoint_layer(block, h, (pe, bias), layer, cfg.remat_policy)
        else:
            h = block(h, pe, bias, layer)
    h = _layer_norm(params["encoder"]["layer_norm"], h, cfg.layer_norm_eps)
    return _linear(params["lm_head"], h).to(torch.float32)
