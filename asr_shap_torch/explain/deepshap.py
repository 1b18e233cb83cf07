"""DeepSHAP: DeepLIFT rescale-rule attributions through autograd Functions.

A forward is written against dual tensors with a leading axis of size 2:
``d[0]`` the actual activation, ``d[1]`` the reference (background) one.
The models take the pair as their batch axis. Linear ops apply to both
halves unchanged, and so do the norms, whose plain gradient is the linear
rule. Each nonlinearity is a ``torch.autograd.Function`` whose backward puts
the DeepLIFT multiplier where the local gradient would be:

  * rescale rule (SiLU, GELU, sigmoid, tanh, ReLU):
      m = (f(x) - f(r)) / (x - r)   where |x - r| > eps, else f'(x);
  * GLU, the exact two-player Shapley split of a * sigmoid(b):
      m_a = (sig(b) + sig(b_r)) / 2,  m_b = (a + a_r) / 2 * rescale(sigmoid).

The actual half's cotangent gets ``g[0] * m``; the reference half's gets
zeros (its pullback does not enter phi). Each Function has
``generate_vmap_rule = True``: its body is plain tensor ops, so
``torch.func.vmap`` batches the explainer's one-hot cotangent rows through
it, as ``expected_gradients._jacobian`` does with the kernels' Functions.

``deep_shap_values`` runs one Jacobian per background row, one row after
another, and averages phi in float32: the DeepExplainer contract.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from asr_shap_torch.explain.expected_gradients import _jacobian
from asr_shap_torch.models.conformer import deepshap_rules
from asr_shap_torch.models.heads import aggregation_head
from asr_shap_torch.models.w2v2_conformer import w2v2_conformer_logits
from asr_shap_torch.models.wav2vec2 import wav2vec2_logits

_EPS = 1e-6
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def dual(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Stack (actual, reference) into a dual tensor [2, ...]."""
    return torch.stack([x, ref])


def actual(d: torch.Tensor) -> torch.Tensor:
    return d[0]


def _secant(f: Callable, df: Callable, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(f(x) - f(r)) / (x - r) where |x - r| > eps, else f'(x)."""
    delta = x - r
    apart = delta.abs() > _EPS
    return torch.where(apart, (f(x) - f(r)) / torch.where(apart, delta, 1.0), df(x))


def _d_silu(x):
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def _gelu_erfc(x):
    """The exact GELU as x * Phi(x) with Phi(x) = erfc(-x / sqrt 2) / 2: no
    cancellation in 1 + erf(x / sqrt 2) for negative x, so the secant of
    two close points keeps its digits there."""
    return 0.5 * x * torch.erfc(-x * _INV_SQRT2)


def _d_gelu(x):  # Phi(x) + x phi(x)
    return 0.5 * torch.erfc(-x * _INV_SQRT2) + x * torch.exp(-0.5 * x * x) * _INV_SQRT_2PI


def _d_sigmoid(x):
    s = torch.sigmoid(x)
    return s * (1.0 - s)


def _d_tanh(x):
    t = torch.tanh(x)
    return 1.0 - t * t


def _d_relu(x):  # 0 at x = 0, as JAX's relu
    return (x > 0).to(x.dtype)


def _make_rescale(name: str, f: Callable, df: Callable, f_secant: Callable = None) -> Callable:
    """Elementwise nonlinearity on dual tensors with the rescale-rule
    backward, as an autograd Function's ``apply``; the backward's secant
    takes ``f_secant`` (the same function, another formula) if given."""
    f_secant = f_secant or f

    def forward(d):
        return f(d)

    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        m = _secant(f_secant, df, d[0], d[1])
        return torch.stack([g[0] * m, torch.zeros_like(g[1])])

    fn = type(name, (torch.autograd.Function,), {
        "generate_vmap_rule": True, "forward": staticmethod(forward),
        "setup_context": staticmethod(setup_context), "backward": staticmethod(backward)})
    return fn.apply


silu_rescale = _make_rescale("SiluRescale", F.silu, _d_silu)
gelu_rescale = _make_rescale("GeluRescale", F.gelu, _d_gelu, _gelu_erfc)
sigmoid_rescale = _make_rescale("SigmoidRescale", torch.sigmoid, _d_sigmoid)
tanh_rescale = _make_rescale("TanhRescale", torch.tanh, _d_tanh)
relu_rescale = _make_rescale("ReluRescale", F.relu, _d_relu)


class GluRescale(torch.autograd.Function):
    """GLU on a dual tensor (the halves along ``axis``) with the exact
    two-player Shapley split as its backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(d, axis):
        return F.glu(d, dim=axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        axis = ctx.axis
        a_x, b_x = d[0].chunk(2, dim=axis)
        a_r, b_r = d[1].chunk(2, dim=axis)
        m_a = 0.5 * (torch.sigmoid(b_x) + torch.sigmoid(b_r))
        m_b = 0.5 * (a_x + a_r) * _secant(torch.sigmoid, _d_sigmoid, b_x, b_r)
        grad = torch.cat([g[0] * m_a, g[0] * m_b], dim=axis)
        return torch.stack([grad, torch.zeros_like(grad)]), None


def glu_rescale(d: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return GluRescale.apply(d, axis)


class DeepExplanation(NamedTuple):
    values: torch.Tensor        # [N_input, T_out]
    base_values: torch.Tensor   # [T_out]
    model_output: torch.Tensor  # [T_out]


def deep_shap_values(f_dual: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                     background: torch.Tensor, output_chunk: int = 0) -> DeepExplanation:
    """DeepSHAP attributions of ``f_dual`` at x [N] against each background
    row [B, N]. f_dual: dual input [2, N] -> outputs [T_out] of the actual
    half, built from the rescale ops above. One Jacobian per background row,
    in turn; phi accumulates in float32. Deterministic."""
    acc = None
    for ref in background:
        jac = _jacobian(lambda xx, ref=ref: f_dual(dual(xx, ref)), x, output_chunk)
        phi = (jac * (x - ref)[None, :]).to(torch.float32)
        acc = phi if acc is None else acc + phi
    with torch.no_grad():
        fx = f_dual(dual(x, x))
        base = torch.stack([f_dual(dual(r, r)) for r in background]).mean(dim=0)
    return DeepExplanation(values=(acc / background.shape[0]).T.contiguous(),
                           base_values=base, model_output=fx)


def _dual_fn(logits_fn, params, model_config, explainer_config, remat, **plugs):
    ec = explainer_config
    use_remat = ec.remat if remat is None else remat

    def f_dual(d: torch.Tensor) -> torch.Tensor:
        logits = logits_fn(params, model_config, d, remat=use_remat, **plugs)  # [2, T, V]
        return aggregation_head(logits, ec.aggregation, ec.token_timestep, ec.token_id)[0]

    return f_dual


def wav2vec2_dual_fn(params, model_config, explainer_config,
                     remat: Optional[bool] = None,
                     tp=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """DeepSHAP dual forward of the Wav2Vec2 CTC model: dual waveform
    [2, N] -> explained outputs [T_out] of the actual half. Its GELUs run
    the rescale rule; norms and attention keep their plain gradient. ``tp``:
    the tensor-parallel mesh of sharded ``params``, or None."""
    return _dual_fn(wav2vec2_logits, params, model_config, explainer_config, remat,
                    gelu=gelu_rescale, tp=tp)


def w2v2_conformer_dual_fn(params, model_config, explainer_config,
                           remat: Optional[bool] = None, tp=None
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """DeepSHAP dual forward of the Wav2Vec2-Conformer: GELU rescale in the
    conv feature encoder, SiLU and GLU rescale in the conformer blocks."""
    return _dual_fn(w2v2_conformer_logits, params, model_config, explainer_config, remat,
                    rules=deepshap_rules(), gelu=gelu_rescale, tp=tp)


def deep_explain_wav2vec2(params, model_config, x: torch.Tensor, background: torch.Tensor,
                          explainer_config) -> DeepExplanation:
    """One-call DeepSHAP attribution of a Wav2Vec2 model at the (normalized)
    waveform x against each background row."""
    f_dual = wav2vec2_dual_fn(params, model_config, explainer_config)
    return deep_shap_values(f_dual, x, background, output_chunk=explainer_config.output_chunk)
