"""Wav2Vec2 CTC model, functional, on a params dict of tensors.

The params tree is the reference package's (see ``core/params_io.py``):
conv kernels ``[K, C_in, C_out]``, linears ``[in, out]``, activations
channels-last ``[B, T, C]``; the encoder layers are a list of per-layer
dicts. Everything is differentiable to the raw waveform, which is what the
explainer needs.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from asr_shap_torch.core.config import Wav2Vec2Config
from asr_shap_torch.core.device import (
    check_matmul_precision,
    precision_active,
    resolve_device,
)
from asr_shap_torch.kernels import conv_dgrad
from asr_shap_torch.ops.attention import multi_head_attention

Params = Dict[str, Any]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as HF's "gelu"


def _layer_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    # float32 statistics whatever the compute dtype
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def _group_norm(p: Params, x: torch.Tensor, num_groups: int,
                eps: float) -> torch.Tensor:
    """x [B, T, C]; normalize per group over (T, C // G), statistics in
    float32 (torch GroupNorm semantics on a [B, C, T] tensor)."""
    b, t, c = x.shape
    xg = x.to(torch.float32).reshape(b, t, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(b, t, c) * p["scale"] + p["bias"]).to(x.dtype)


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
            padding: int = 0, groups: int = 1,
            bias: Optional[torch.Tensor] = None,
            impl: str = "lax") -> torch.Tensor:
    """x [B, T, C_in], kernel [K, C_in // groups, C_out] -> [B, T', C_out].

    ``impl="pallas"`` sends the layers the dgrad kernel takes
    (``conv_dgrad.eligible``) through K1's Function; every other conv, and
    every conv under ``impl="lax"``, is ``F.conv1d``. A grouped conv (the
    positional embedding, the conformer's depthwise conv) in bf16 runs on
    float32 copies of its operands and rounds its output to bf16: the
    reference's arithmetic (float32 sums, output in the input's dtype), and
    on the H100 cuDNN's bf16 input gradient of the positional conv took
    433 ms per call at the base path's shape against 3.4 ms in float32
    (``chip_smoke.py``, "timing positional conv dgrad"; the depthwise conv's
    two routes: "timing depthwise conv dgrad")."""
    if impl not in ("lax", "pallas"):
        raise NotImplementedError(f"conv_impl {impl!r} is not ported")
    if impl == "pallas" and conv_dgrad.eligible(
            kernel.shape[1], kernel.shape[2], stride, groups, padding):
        y = conv_dgrad.conv1d(x, kernel, stride)
    elif groups > 1 and x.dtype == torch.bfloat16:
        y = conv_dgrad.conv1d_forward(x.float(), kernel.float(), stride, padding,
                                      groups).to(x.dtype)
    else:
        y = conv_dgrad.conv1d_forward(x, kernel, stride, padding, groups)
    if bias is not None:
        y = y + bias
    return y


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class ParamInit:
    """Numpy-seeded parameter draws, as float32 tensors on ``device``:
    fan-in uniform linears, normal convs, unit norms (the reference's
    scheme; its draws differ)."""

    def __init__(self, rng: np.random.Generator, device: torch.device):
        self.rng = rng
        self.device = device

    def tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def normal(self, shape, std) -> torch.Tensor:
        return self.tensor(self.rng.standard_normal(shape, dtype=np.float32)
                           * np.float32(std))

    def linear(self, d_in: int, d_out: int, bias: bool = True) -> Params:
        bound = 1.0 / math.sqrt(d_in)
        p = {"kernel": self.tensor(self.rng.uniform(-bound, bound, (d_in, d_out)))}
        if bias:
            p["bias"] = self.tensor(np.zeros(d_out))
        return p

    def norm(self, dim: int) -> Params:
        return {"scale": self.tensor(np.ones(dim)), "bias": self.tensor(np.zeros(dim))}


def init_conv_encoder(init: ParamInit, config: Wav2Vec2Config) -> list:
    """The conv feature encoder's layers, which Wav2Vec2 shares with the
    Wav2Vec2-Conformer."""
    cfg = config
    conv_layers = []
    in_ch = 1
    for i, (dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        layer: Params = {"conv": {"kernel": init.normal((k, in_ch, dim),
                                                        math.sqrt(2.0 / (k * in_ch)))}}
        if cfg.conv_bias:
            layer["conv"]["bias"] = init.tensor(np.zeros(dim))
        if (cfg.feat_extract_norm == "group" and i == 0) or cfg.feat_extract_norm == "layer":
            layer["norm"] = init.norm(dim)
        conv_layers.append(layer)
        in_ch = dim
    return conv_layers


def init_wav2vec2_params(seed: int, config: Wav2Vec2Config,
                         device: str | torch.device = "cuda") -> Params:
    """Random initialization from a numpy seed (see ``ParamInit``)."""
    init = ParamInit(np.random.default_rng(seed), resolve_device(device))
    cfg = config
    conv_layers = init_conv_encoder(init, cfg)

    h = cfg.hidden_size
    pos_k = cfg.num_conv_pos_embeddings
    layers = [{
        "attention": {name: init.linear(h, h) for name in ("q", "k", "v", "out")},
        "layer_norm": init.norm(h),
        "ffn": {"intermediate": init.linear(h, cfg.intermediate_size),
                "output": init.linear(cfg.intermediate_size, h)},
        "final_layer_norm": init.norm(h),
    } for _ in range(cfg.num_hidden_layers)]

    return {
        "feature_encoder": conv_layers,
        "feature_projection": {"layer_norm": init.norm(cfg.feat_proj_dim),
                               "projection": init.linear(cfg.feat_proj_dim, h)},
        "encoder": {
            "pos_conv": {
                "kernel": init.normal((pos_k, h // cfg.num_conv_pos_embedding_groups, h),
                                      math.sqrt(4.0 / (pos_k * h))),
                "bias": init.tensor(np.zeros(h)),
            },
            "layer_norm": init.norm(h),
            "layers": layers,
        },
        "lm_head": init.linear(h, cfg.vocab_size),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: str) -> torch.dtype:
    """A config's ``dtype`` ("float32" or "bfloat16") as a torch dtype."""
    if dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"dtype {dtype!r}: only {sorted(COMPUTE_DTYPES)} are ported")
    return COMPUTE_DTYPES[dtype]


def cast_params_for_compute(params: Params, dtype: str) -> Params:
    """The floating leaves of ``params`` cast to the compute dtype (shared by
    every model's bf16 path); float32 is a no-op, and a leaf already in the
    dtype is returned as it is, so params cast once up front cost nothing
    per call."""
    dt = compute_dtype(dtype)
    if dt == torch.float32:
        return params

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        if torch.is_tensor(x) and x.is_floating_point() and x.dtype != dt:
            return x.to(dt)
        return x

    return cast(params)


def feature_lengths(config: Wav2Vec2Config, lengths: torch.Tensor) -> torch.Tensor:
    """Audio-sample lengths -> feature-encoder frame lengths."""
    out = lengths
    for k, s in zip(config.conv_kernel, config.conv_stride):
        out = torch.div(out - k, s, rounding_mode="floor") + 1
    return out


def feature_encoder(params: Params, config: Wav2Vec2Config,
                    x: torch.Tensor, gelu=_gelu) -> torch.Tensor:
    """Raw waveform [B, N] -> features [B, T, C]; x320 total stride. The
    compute dtype is the waveform's (float32, bf16 or float16; anything
    else is taken as float32). ``gelu`` is the activation after each conv
    layer (``explain.deepshap.gelu_rescale`` on a dual batch)."""
    h = x[..., None]
    if h.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        h = h.to(torch.float32)
    for i, layer in enumerate(params["feature_encoder"]):
        h = _conv1d(h, layer["conv"]["kernel"], stride=config.conv_stride[i],
                    bias=layer["conv"].get("bias"), impl=config.conv_impl)
        if config.feat_extract_norm == "group" and i == 0:
            h = _group_norm(layer["norm"], h, num_groups=config.conv_dim[0],
                            eps=config.layer_norm_eps)
        elif config.feat_extract_norm == "layer":
            h = _layer_norm(layer["norm"], h, eps=config.layer_norm_eps)
        h = gelu(h)
    return h


def _pos_conv_embedding(params: Params, config: Wav2Vec2Config,
                        h: torch.Tensor, gelu=_gelu) -> torch.Tensor:
    """Grouped, padded conv positional embedding; an even kernel drops the
    last frame (the 'same' trim); then GELU."""
    p = params["encoder"]["pos_conv"]
    y = _conv1d(h, p["kernel"], stride=1,
                padding=config.num_conv_pos_embeddings // 2,
                groups=config.num_conv_pos_embedding_groups, bias=p["bias"])
    if config.num_conv_pos_embeddings % 2 == 0:
        y = y[:, :-1, :]
    return gelu(y)


def _encoder_layer(layer: Params, config: Wav2Vec2Config, h: torch.Tensor,
                   bias: Optional[torch.Tensor], gelu=_gelu) -> torch.Tensor:
    """One encoder layer: post-LN (base) or pre-LN (do_stable_layer_norm)."""
    cfg = config
    b, t, d = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim

    def heads(p, x):
        return _linear(p, x).reshape(b, t, nh, hd).transpose(1, 2)

    def attend(x):
        att = layer["attention"]
        o = multi_head_attention(heads(att["q"], x), heads(att["k"], x),
                                 heads(att["v"], x), bias, impl=cfg.attention_impl)
        return _linear(att["out"], o.transpose(1, 2).reshape(b, t, d))

    def ffn(x):
        return _linear(layer["ffn"]["output"],
                       gelu(_linear(layer["ffn"]["intermediate"], x)))

    if cfg.do_stable_layer_norm:
        h = h + attend(_layer_norm(layer["layer_norm"], h, cfg.layer_norm_eps))
        h = h + ffn(_layer_norm(layer["final_layer_norm"], h, cfg.layer_norm_eps))
    else:
        h = _layer_norm(layer["layer_norm"], h + attend(h), cfg.layer_norm_eps)
        h = _layer_norm(layer["final_layer_norm"], h + ffn(h), cfg.layer_norm_eps)
    return h


def encoder(params: Params, config: Wav2Vec2Config, h: torch.Tensor,
            frame_mask: Optional[torch.Tensor] = None,
            remat: bool = False, gelu=_gelu) -> torch.Tensor:
    """Transformer encoder over features [B, T, H]; ``gelu`` is the
    positional conv's and the FFNs' activation.

    ``remat`` is accepted for signature parity and does nothing: the
    explainer's forward runs at batch 1, so its saved activations are small
    and recomputing them would only add time."""
    cfg = config
    bias = None
    if frame_mask is not None:
        h = h * frame_mask[..., None]
        bias = torch.where(frame_mask[:, None, None, :] != 0, 0.0, -1e9).to(h.dtype)
    h = h + _pos_conv_embedding(params, cfg, h, gelu)
    if not cfg.do_stable_layer_norm:
        h = _layer_norm(params["encoder"]["layer_norm"], h, cfg.layer_norm_eps)
    for layer in params["encoder"]["layers"]:
        h = _encoder_layer(layer, cfg, h, bias, gelu)
    if cfg.do_stable_layer_norm:
        h = _layer_norm(params["encoder"]["layer_norm"], h, cfg.layer_norm_eps)
    return h


def wav2vec2_logits(params: Params, config: Wav2Vec2Config,
                    input_values: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    remat: bool = False, gelu=_gelu) -> torch.Tensor:
    """Normalized waveform [B, N] -> CTC logits [B, T_frames, vocab], float32.
    ``lengths`` enables padded batching. ``gelu`` replaces every GELU of the
    model (DeepSHAP passes ``explain.deepshap.gelu_rescale``, the batch axis
    carrying the (actual, reference) pair). ``config.dtype="bfloat16"`` runs
    activations and params in bf16 (params cast here, a no-op for leaves
    already bf16; norm statistics stay float32). On CUDA it must run inside
    ``core.device.matmul_precision_scope(config.matmul_precision)``, else it
    raises: the model does not change torch's process-wide switches itself."""
    cfg = config
    params = cast_params_for_compute(params, cfg.dtype)
    h = projected_features(params, cfg, input_values.to(compute_dtype(cfg.dtype)), gelu)
    frame_mask = None if lengths is None else frame_mask_for(cfg, lengths, h)
    h = encoder(params, cfg, h, frame_mask, remat=remat, gelu=gelu)
    return _linear(params["lm_head"], h).to(torch.float32)


def projected_features(params: Params, config: Wav2Vec2Config,
                       input_values: torch.Tensor, gelu=_gelu) -> torch.Tensor:
    """Waveform [B, N] (in the compute dtype) -> projected features [B, T,
    hidden]: the numerics checks, the conv feature encoder (``gelu`` after
    each conv layer) and the feature projection."""
    cfg = config
    check_matmul_precision(cfg.matmul_precision)
    if input_values.is_cuda and not precision_active(cfg.matmul_precision):
        raise RuntimeError(
            f"matmul_precision={cfg.matmul_precision!r} but torch's precision switches "
            f"are not its own: run the model inside core.device.matmul_precision_scope("
            f"{cfg.matmul_precision!r})")
    feats = feature_encoder(params, cfg, input_values, gelu)
    fp = params["feature_projection"]
    return _linear(fp["projection"], _layer_norm(fp["layer_norm"], feats,
                                                 cfg.layer_norm_eps))


def frame_mask_for(config: Wav2Vec2Config, lengths: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """[B] sample lengths -> [B, T] frame mask (1 valid, 0 padded) in h's dtype."""
    t = h.shape[1]
    fl = feature_lengths(config, lengths.to(h.device))
    return (torch.arange(t, device=h.device)[None, :] < fl[:, None]).to(h.dtype)
