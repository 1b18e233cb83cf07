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
from asr_shap_torch.ops.remat import checkpoint_layer, dot
from asr_shap_torch.parallel.tp import copy_to_tp, row_linear

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
    y = dot(x, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def _gemm_blocks(k: int, stride: int, t_out: int):
    """(m, need) of the stride-blocked formulation: m = ceil(K / s) blocks
    of s rows, over the first ``need`` = (T_out + m - 1) s input rows."""
    m = -(-k // stride)
    return m, (t_out + m - 1) * stride


def _gemm_kernel(kernel: torch.Tensor, stride: int, m: int) -> torch.Tensor:
    """W [K, C_in, C_out] -> Wq [m, s C_in, C_out], Wq[q, r C_in + c] =
    W[s q + r, c], zero past K."""
    k, c_in, c_out = kernel.shape
    return F.pad(kernel, (0, 0, 0, 0, 0, m * stride - k)).reshape(m, stride * c_in, c_out)


def _conv1d_gemm(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """Valid strided conv1d as m = ceil(K / s) dense GEMMs over stride blocks
    (``conv_impl="gemm"``, the reference's ``_conv1d_gemm``):

      xb[u] = x[s u : s u + s]  (a row-major view),  y[t] = sum_q xb[t + q] @ Wq

    The same sums as the conv in another order. Its backward is autograd's
    through the matmuls."""
    b, t, c_in = x.shape
    k, _, c_out = kernel.shape
    t_out = (t - k) // stride + 1
    m, need = _gemm_blocks(k, stride, t_out)
    if need > t:
        x = F.pad(x, (0, 0, 0, need - t))
    xb = x[:, :need].reshape(b, t_out + m - 1, stride * c_in)
    wq = _gemm_kernel(kernel, stride, m)
    y = xb[:, :t_out] @ wq[0]
    for q in range(1, m):
        y = y + xb[:, q:q + t_out] @ wq[q]
    return y


def _conv1d_gemm_vjp(x: torch.Tensor, kernel: torch.Tensor, ybar: torch.Tensor,
                     stride: int, need_x: bool, need_kernel: bool):
    """The GEMM formulation's transpose: (xbar, kernel bar) for the
    cotangent ``ybar`` [B, T_out, C_out] of ``_conv1d_gemm(x, kernel,
    stride)``, each None where not asked for. Plain matmuls and pads, so
    that it batches under vmap."""
    b, t, c_in = x.shape
    k, _, c_out = kernel.shape
    t_out = ybar.shape[-2]
    m, need = _gemm_blocks(k, stride, t_out)
    wq = _gemm_kernel(kernel, stride, m)
    dx = dw = None
    if need_x:
        # xb[t + q] feeds y[t] through Wq: its cotangent is ybar[t] @ Wq^T,
        # shifted down q blocks
        dxb = sum(F.pad(ybar @ wq[q].transpose(0, 1), (0, 0, q, m - 1 - q))
                  for q in range(m))
        dx = dxb.reshape(b, need, c_in)
        dx = dx[:, :t] if need >= t else F.pad(dx, (0, 0, 0, t - need))
    if need_kernel:
        xp = F.pad(x, (0, 0, 0, need - t)) if need > t else x
        xb = xp[:, :need].reshape(b, t_out + m - 1, stride * c_in)
        dwq = torch.stack([torch.einsum("bti,bto->io", xb[:, q:q + t_out], ybar)
                           for q in range(m)])
        dw = dwq.reshape(m * stride, c_in, c_out)[:k]
    return dx, dw


class Conv1dHybrid(torch.autograd.Function):
    """``conv_impl="hybrid"``: the library conv forward (``F.conv1d``) with
    the GEMM formulation's backward, as the reference's ``_conv1d_hybrid``.
    Its backward is plain torch ops, so the generated vmap rule batches the
    explainer's cotangent rows through it."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, kernel, stride):
        return conv_dgrad.conv1d_forward(x, kernel, stride)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kernel, stride = inputs
        ctx.stride = stride
        ctx.save_for_backward(x, kernel)

    @staticmethod
    def backward(ctx, ybar):
        x, kernel = ctx.saved_tensors
        dx, dw = _conv1d_gemm_vjp(x, kernel, ybar, ctx.stride, ctx.needs_input_grad[0],
                                  ctx.needs_input_grad[1])
        return dx, dw, None


CONV_IMPLS = ("lax", "pallas", "gemm", "hybrid")


def _conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
            padding: int = 0, groups: int = 1,
            bias: Optional[torch.Tensor] = None,
            impl: str = "lax") -> torch.Tensor:
    """x [B, T, C_in], kernel [K, C_in // groups, C_out] -> [B, T', C_out].

    ``impl`` selects the formulation of the ungrouped, unpadded, strided
    convs (the feature encoder's): "lax" is ``F.conv1d``; "gemm" the
    stride-blocked GEMMs both ways; "hybrid" ``F.conv1d`` forward with the
    GEMM backward; "pallas" sends the layers the dgrad kernel takes
    (``conv_dgrad.eligible``) through K1's Function. Every other conv is
    ``F.conv1d``. A grouped conv (the positional embedding, the conformer's
    depthwise conv) in bf16 runs on float32 copies of its operands and
    rounds its output to bf16: the reference's arithmetic (float32 sums,
    output in the input's dtype), and on the H100 cuDNN's bf16 input
    gradient of the positional conv took 433 ms per call at the base path's
    shape against 3.4 ms in float32 (``chip_smoke.py``, "timing positional
    conv dgrad"; the depthwise conv's two routes: "timing depthwise conv
    dgrad")."""
    if impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {impl!r}: one of {CONV_IMPLS}")
    eligible = groups == 1 and padding == 0 and stride > 1
    if impl == "gemm" and eligible:
        y = _conv1d_gemm(x, kernel, stride)
    elif impl == "hybrid" and eligible:
        y = Conv1dHybrid.apply(x, kernel, stride)
    elif impl == "pallas" and conv_dgrad.eligible(
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
                   bias: Optional[torch.Tensor], gelu=_gelu, tp=None) -> torch.Tensor:
    """One encoder layer: post-LN (base) or pre-LN (do_stable_layer_norm).
    Under a tensor-parallel mesh ``tp`` the layer holds this rank's heads
    and FFN columns (``parallel/tp.py``); the head count comes from the q
    projection's width."""
    cfg = config
    b, t, _ = h.shape
    att = layer["attention"]
    hd = cfg.head_dim
    nh = att["q"]["kernel"].shape[-1] // hd

    def heads(p, x):
        return _linear(p, x).reshape(b, t, nh, hd).transpose(1, 2)

    def attend(x):
        x = copy_to_tp(x, tp)
        o = multi_head_attention(heads(att["q"], x), heads(att["k"], x),
                                 heads(att["v"], x), bias, impl=cfg.attention_impl)
        return row_linear(att["out"], o.transpose(1, 2).reshape(b, t, nh * hd), tp)

    def ffn(x):
        return row_linear(layer["ffn"]["output"],
                          gelu(_linear(layer["ffn"]["intermediate"], copy_to_tp(x, tp))), tp)

    if cfg.do_stable_layer_norm:
        h = h + attend(_layer_norm(layer["layer_norm"], h, cfg.layer_norm_eps))
        h = h + ffn(_layer_norm(layer["final_layer_norm"], h, cfg.layer_norm_eps))
    else:
        h = _layer_norm(layer["layer_norm"], h + attend(h), cfg.layer_norm_eps)
        h = _layer_norm(layer["final_layer_norm"], h + ffn(h), cfg.layer_norm_eps)
    return h


def encoder(params: Params, config: Wav2Vec2Config, h: torch.Tensor,
            frame_mask: Optional[torch.Tensor] = None,
            remat: bool = False, gelu=_gelu, tp=None) -> torch.Tensor:
    """Transformer encoder over features [B, T, H]; ``gelu`` is the
    positional conv's and the FFNs' activation; ``tp`` the tensor-parallel
    mesh of sharded params (``parallel/tp.py``), or None.

    ``remat`` recomputes each encoder layer in the backward under
    ``config.remat_policy`` ("full" or "dots", ``ops/remat.py``), as the
    reference's ``jax.checkpoint`` of its layer body; the positional conv
    and the feature encoder keep their activations, as there."""
    cfg = config
    bias = None
    if frame_mask is not None:
        h = h * frame_mask[..., None]
        bias = torch.where(frame_mask[:, None, None, :] != 0, 0.0, -1e9).to(h.dtype)
    h = h + _pos_conv_embedding(params, cfg, h, gelu)
    if not cfg.do_stable_layer_norm:
        h = _layer_norm(params["encoder"]["layer_norm"], h, cfg.layer_norm_eps)

    def layer_fn(x, b, layer):
        return _encoder_layer(layer, cfg, x, b, gelu, tp)

    for layer in params["encoder"]["layers"]:
        if remat:
            h = checkpoint_layer(layer_fn, h, (bias,), layer, cfg.remat_policy)
        else:
            h = layer_fn(h, bias, layer)
    if cfg.do_stable_layer_norm:
        h = _layer_norm(params["encoder"]["layer_norm"], h, cfg.layer_norm_eps)
    return h


def wav2vec2_logits(params: Params, config: Wav2Vec2Config,
                    input_values: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    remat: bool = False, gelu=_gelu, tp=None) -> torch.Tensor:
    """Normalized waveform [B, N] -> CTC logits [B, T_frames, vocab], float32.
    ``lengths`` enables padded batching. ``gelu`` replaces every GELU of the
    model (DeepSHAP passes ``explain.deepshap.gelu_rescale``, the batch axis
    carrying the (actual, reference) pair). ``config.dtype="bfloat16"`` runs
    activations and params in bf16 (params cast here, a no-op for leaves
    already bf16; norm statistics stay float32). On CUDA it must run inside
    ``core.device.matmul_precision_scope(config.matmul_precision)``, else it
    raises: the model does not change torch's process-wide switches itself.
    ``tp`` is the tensor-parallel mesh of params sharded by
    ``parallel.tp.shard_params_tp``, or None."""
    cfg = config
    params = cast_params_for_compute(params, cfg.dtype)
    h = projected_features(params, cfg, input_values.to(compute_dtype(cfg.dtype)), gelu)
    frame_mask = None if lengths is None else frame_mask_for(cfg, lengths, h)
    h = encoder(params, cfg, h, frame_mask, remat=remat, gelu=gelu, tp=tp)
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
