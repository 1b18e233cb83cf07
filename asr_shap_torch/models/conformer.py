"""Conformer CTC encoder on log-mel features, functional, on a params dict
of tensors.

The port of ``asr_shap/models/conformer.py``: the torchaudio-style
Conformer of the mel SHAP study (80 mels, GLU conv module, batch or group
norm, depthwise kernel 31, a linear CTC head) and, through the striding
conv subsampler, relative positions and the input scale, the NeMo BPE-CTC
Conformer of ``models/nemo_ctc.py``. Inputs are features ``[..., T, F]``:
the leading axes may be a batch, or the (actual, reference) pair of a
DeepSHAP dual forward.

The nonlinearities are pluggable (``Rules``): the same forward runs with
plain ops, or with the DeepSHAP rescale ops of ``explain/deepshap.py``
(``deepshap_rules``). The subsampler's ReLU stays plain under DeepSHAP, as
in the reference. Attention dispatches to the flash kernels under
``attention_impl="pallas"``: no bias, or a ``[B, 1, 1, T]`` key mask with
``lengths`` (K2, K3, K4); the rel-pos scores, masked or not, as a full
``[B, H, T, T]`` score bias (K2f, K3b, K4f). The 2-D subsampler convs, the
depthwise conv and the linears are library calls, as in the reference.
BatchNorm runs in inference mode.

The params tree is the reference's with one dict per layer in
``params["layers"]`` (see ``core/params_io.py``). ``dtype="bfloat16"``
runs the reference's bf16 forward: params and features cast to bf16, norm
statistics in float32, the head's products exact and its output float32.
The config has no ``matmul_precision``: the model runs under "highest" for
float32 and "default" for bf16, and on CUDA raises outside that scope
(``core.device.matmul_precision_scope``), since the explainer's backward
runs after the forward has returned.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from asr_shap_torch.core.config import ConformerConfig
from asr_shap_torch.core.device import precision_active, resolve_device
from asr_shap_torch.models.wav2vec2 import (
    ParamInit,
    _conv1d,
    _layer_norm as _ln,
    _linear,
    cast_params_for_compute,
    compute_dtype,
)
from asr_shap_torch.ops.attention import multi_head_attention, rel_pos_embedding, rel_shift
from asr_shap_torch.ops.remat import checkpoint_layer

Params = Dict[str, Any]


class Rules(NamedTuple):
    """Pluggable nonlinearities: plain ops for inference, rescale ops for
    DeepSHAP's dual forwards."""

    silu: Callable
    glu: Callable  # (x, axis) -> gated half


def _plain_glu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """a * sigmoid(b) of the two halves of ``x`` along ``axis``."""
    return F.glu(x, dim=axis)


PLAIN_RULES = Rules(silu=F.silu, glu=_plain_glu)


def deepshap_rules() -> Rules:
    from asr_shap_torch.explain.deepshap import glu_rescale, silu_rescale

    return Rules(silu=silu_rescale, glu=glu_rescale)


def precision_for(config: ConformerConfig) -> str:
    """The matmul precision the reference fixes from the dtype: "highest"
    for float32, "default" for bf16."""
    return "highest" if compute_dtype(config.dtype) == torch.float32 else "default"


# --------------------------------------------------------------------- init

def init_conformer_params(seed: int, config: ConformerConfig,
                          device: str | torch.device = "cuda") -> Params:
    """Random initialization from a numpy seed with the reference's shapes
    and scales (``ParamInit``'s scheme; u/v biases zero, BatchNorm at
    identity statistics)."""
    init = ParamInit(np.random.default_rng(seed), resolve_device(device))
    cfg = config
    d, ksz = cfg.hidden_size, cfg.conv_kernel_size
    ffn = d * cfg.ffn_expansion
    zeros = lambda *shape: init.tensor(np.zeros(shape))
    ones = lambda *shape: init.tensor(np.ones(shape))

    def ffn_block():
        return {"norm": init.norm(d), "in": init.linear(d, ffn), "out": init.linear(ffn, d)}

    def layer():
        attn: Params = {"norm": init.norm(d),
                        **{name: init.linear(d, d) for name in ("q", "k", "v", "out")}}
        if cfg.pos_encoding == "relative":
            attn["pos"] = init.linear(d, d, bias=False)
            attn["bias_u"] = zeros(cfg.num_attention_heads, cfg.head_dim)
            attn["bias_v"] = zeros(cfg.num_attention_heads, cfg.head_dim)
        return {
            "ffn1": ffn_block(),
            "attn": attn,
            "conv": {
                "norm": init.norm(d),
                "pointwise1": init.linear(d, 2 * d),
                "depthwise": {"kernel": init.normal((ksz, 1, d), math.sqrt(1.0 / ksz)),
                              "bias": zeros(d)},
                "bn": {"scale": ones(d), "bias": zeros(d), "mean": zeros(d), "var": ones(d)},
                "pointwise2": init.linear(d, d),
            },
            "ffn2": ffn_block(),
            "final_norm": init.norm(d),
        }

    params: Params = {"layers": [layer() for _ in range(cfg.num_layers)],
                      "head": init.linear(d, cfg.vocab_size)}
    if cfg.subsampling == "striding":
        params["subsampling"] = init_subsampling_params(init, cfg)
    elif cfg.input_dim != cfg.hidden_size:
        params["input_proj"] = init.linear(cfg.input_dim, d)
    return params


def init_subsampling_params(init: ParamInit, config: ConformerConfig) -> Params:
    """The striding subsampler (NeMo's): ``subsampling_layers`` 2-D convs
    over (time, mel), kernel 3, stride 2, pad 1, ReLU, HWIO kernels, then a
    linear from the channel-major (C, F) flatten onto hidden_size."""
    cfg = config
    ch = cfg.subsampling_conv_channels or cfg.hidden_size
    convs, c_in = [], 1
    for _ in range(cfg.subsampling_layers):
        convs.append({"kernel": init.normal((3, 3, c_in, ch), math.sqrt(2.0 / (9 * c_in))),
                      "bias": init.tensor(np.zeros(ch))})
        c_in = ch
    f_out = cfg.subsampled_length(cfg.input_dim)
    return {"convs": convs, "out": init.linear(ch * f_out, cfg.hidden_size)}


# ------------------------------------------------------------------ forward

def _ffn(p: Params, x: torch.Tensor, rules: Rules, eps: float) -> torch.Tensor:
    h = _linear(p["in"], _ln(p["norm"], x, eps))
    return _linear(p["out"], rules.silu(h))


def _attention(p: Params, cfg: ConformerConfig, x: torch.Tensor,
               bias: Optional[torch.Tensor], eps: float,
               pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head self-attention over x [..., T, d]: no leading axis gets a
    batch axis of one, so the kernels always see [B, H, T, D]. With ``pe``
    the Transformer-XL content-position scores (q + bias_v) . proj(pe),
    rel-shifted and pre-scaled by hd^-1/2, add to ``bias`` as a full score
    bias, and q takes bias_u."""
    *lead, t, d = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    xn = _ln(p["norm"], x, eps)

    def proj(pp):
        return _linear(pp, xn).reshape(*lead, t, nh, hd).movedim(-2, -3)  # [..., H, T, D]

    q, k, v = proj(p["q"]), proj(p["k"]), proj(p["v"])
    if not lead:
        q, k, v = q[None], k[None], v[None]
    if pe is not None:
        p_proj = _linear(p["pos"], pe).reshape(-1, nh, hd)           # [2T-1, H, hd]
        q_v = q + p["bias_v"][None, :, None, :]
        rel = rel_shift(torch.einsum("bhtd,rhd->bhtr", q_v, p_proj)) * hd ** -0.5
        bias = rel if bias is None else rel + bias
        q = q + p["bias_u"][None, :, None, :]
    o = multi_head_attention(q, k, v, bias, impl=cfg.attention_impl)
    if not lead:
        o = o[0]
    return _linear(p["out"], o.movedim(-3, -2).reshape(*lead, t, d))


def conv_subsampling(p: Params, cfg: ConformerConfig, x: torch.Tensor,
                     relu: Callable = F.relu) -> torch.Tensor:
    """Mel features [..., T, F] -> subsampled hidden [..., T', hidden_size]:
    stride-2 2-D convs over (time, mel) with ``relu``, the channel-major
    (C, F) flatten of the NeMo weight layout, then the linear."""
    lead = x.shape[:-2]
    t, f = x.shape[-2:]
    h = x.reshape(-1, 1, t, f)                                        # NCHW
    for conv in p["convs"]:
        h = relu(F.conv2d(h, conv["kernel"].permute(3, 2, 0, 1), conv["bias"],
                          stride=2, padding=1))
    b, c, t2, f2 = h.shape
    h = _linear(p["out"], h.transpose(1, 2).reshape(b, t2, c * f2))
    return h.reshape(*lead, t2, cfg.hidden_size)


def _conv_module(p: Params, cfg: ConformerConfig, x: torch.Tensor, rules: Rules,
                 eps: float, frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LN, pointwise conv, GLU, the padded frames zeroed again, depthwise
    conv with SAME padding (a library conv; in bf16 on float32 copies, see
    ``wav2vec2._conv1d``), inference BatchNorm or GroupNorm over (T, C/G)
    with float32 statistics, SiLU, pointwise conv."""
    h = rules.glu(_linear(p["pointwise1"], _ln(p["norm"], x, eps)), -1)
    if frame_mask is not None:
        h = h * frame_mask[..., None]
    lead = h.shape[:-2]
    t, d = h.shape[-2:]
    ksz = cfg.conv_kernel_size
    pad = (ksz - 1) // 2
    h2 = h.reshape(-1, t, d)
    if ksz % 2 == 0:  # SAME puts the odd frame of padding on the right
        h2 = F.pad(h2, (0, 0, 0, 1))
    h = _conv1d(h2, p["depthwise"]["kernel"], padding=pad, groups=d,
                bias=p["depthwise"]["bias"]).reshape(*lead, t, d)
    bn = p["bn"]
    if cfg.conv_norm == "batch":
        h = (h - bn["mean"]) * torch.rsqrt(bn["var"] + eps) * bn["scale"] + bn["bias"]
    else:  # torch GroupNorm semantics over (T, C/G), float32 statistics
        g = cfg.num_conv_groups
        hg = h.to(torch.float32).reshape(*lead, t, g, d // g)
        mean = hg.mean(dim=(-3, -1), keepdim=True)
        var = (hg - mean).square().mean(dim=(-3, -1), keepdim=True)
        hg = (hg - mean) * torch.rsqrt(var + eps)
        h = (hg.reshape(*lead, t, d) * bn["scale"] + bn["bias"]).to(h.dtype)
    return _linear(p["pointwise2"], rules.silu(h))


def _conformer_layer(layer: Params, cfg: ConformerConfig, x: torch.Tensor, rules: Rules,
                     bias: Optional[torch.Tensor], frame_mask: Optional[torch.Tensor],
                     pe: Optional[torch.Tensor] = None) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    x = x + 0.5 * _ffn(layer["ffn1"], x, rules, eps)
    x = x + _attention(layer["attn"], cfg, x, bias, eps, pe)
    x = x + _conv_module(layer["conv"], cfg, x, rules, eps, frame_mask)
    x = x + 0.5 * _ffn(layer["ffn2"], x, rules, eps)
    return _ln(layer["final_norm"], x, eps)


def conformer_encode(params: Params, config: ConformerConfig, x: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     rules: Rules = PLAIN_RULES, remat: bool = False) -> torch.Tensor:
    """Features [..., T, input_dim] -> encoded [..., T', hidden], in the
    compute dtype. With a "striding" subsampler T' = subsampled_length(T),
    and ``lengths`` [B] count subsampled frames. ``remat`` recomputes each
    layer in the backward ("full", ``ops/remat.py``), as the reference's
    ``jax.checkpoint`` of its layer body; the subsampler keeps its
    activations. On CUDA it raises outside
    ``matmul_precision_scope(precision_for(config))``."""
    cfg = config
    dtype = compute_dtype(cfg.dtype)
    precision = precision_for(cfg)
    if x.is_cuda and not precision_active(precision):
        raise RuntimeError(
            f"a {cfg.dtype} ConformerConfig runs under matmul precision {precision!r}, "
            f"but torch's precision switches are not its own: run the model inside "
            f"core.device.matmul_precision_scope({precision!r})")
    params = cast_params_for_compute(params, cfg.dtype)
    x = x.to(dtype)
    if "subsampling" in params:
        x = conv_subsampling(params["subsampling"], cfg, x)
    elif "input_proj" in params:
        x = _linear(params["input_proj"], x)
    if cfg.input_scale:
        x = x * math.sqrt(cfg.hidden_size)
    bias = frame_mask = None
    if lengths is not None:
        t = x.shape[-2]
        frame_mask = (torch.arange(t, device=x.device)[None, :]
                      < lengths.to(x.device)[:, None]).to(x.dtype)
        bias = torch.where(frame_mask[:, None, None, :] != 0, 0.0, -1e9).to(x.dtype)
        x = x * frame_mask[..., None]
    pe = None
    if cfg.pos_encoding == "relative":
        pe = rel_pos_embedding(x.shape[-2], cfg.hidden_size, device=x.device).to(x.dtype)

    def body(h, bias_, mask_, pe_, layer):
        return _conformer_layer(layer, cfg, h, rules, bias_, mask_, pe_)

    for layer in params["layers"]:
        if remat:
            x = checkpoint_layer(body, x, (bias, frame_mask, pe), layer)
        else:
            x = body(x, bias, frame_mask, pe, layer)
    return x


def conformer_logits(params: Params, config: ConformerConfig, features: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     rules: Rules = PLAIN_RULES, remat: bool = False) -> torch.Tensor:
    """Log-mel features [..., T, F] -> CTC logits [..., T', vocab], float32.
    In bf16 the head is the reference's "highest" product of bf16 operands:
    a float32 GEMM of the bf16-rounded operands (exact products under
    either precision's switches: a bf16 significand is exact in TF32),
    rounded to bf16, plus the bf16 bias, then cast to float32."""
    h = conformer_encode(params, config, features, lengths, rules, remat)
    head = params["head"]
    if h.dtype == torch.float32:
        return _linear(head, h)
    kernel = head["kernel"].to(h.dtype).to(torch.float32)
    y = (h.to(torch.float32) @ kernel).to(h.dtype) + head["bias"].to(h.dtype)
    return y.to(torch.float32)
