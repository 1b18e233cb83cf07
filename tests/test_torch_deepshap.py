"""The port's DeepSHAP against the reference package: each rescale op's
backward under vjp + vmap, and ``deep_shap_values`` through the dual
forwards of the narrow Wav2Vec2 and rel-pos Wav2Vec2-Conformer, whose conv
and attention go through the kernels' Functions (the reference in interpret
mode)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain import deepshap as jds
from asr_shap_torch.core import config as port_config
from asr_shap_torch.explain import deepshap as ds
from asr_shap_torch.kernels import LAUNCHES
from asr_shap_torch.models.heads import make_explained_fn
from torch_port_configs import (
    conformer_params,
    narrow_conformer_config,
    narrow_config,
    port_cfg,
    shared_params,
)

OPS = ("silu", "gelu", "sigmoid", "tanh", "relu", "glu")


def _dual_input(rng):
    """A dual [2, 4, 10] with |x - r| <= 1e-6 on two columns (one exactly
    equal), and x = r = 0 on a third, where f'(x) is used."""
    d = rng.standard_normal((2, 4, 10)).astype(np.float32)
    d[1, :, 0] = d[0, :, 0]
    d[1, :, 1] = d[0, :, 1] + np.float32(5e-7)
    d[:, :, 2] = 0.0
    return d


@pytest.mark.parametrize("op", OPS)
def test_rescale_op_matches_reference(rng, op):
    """The op's output and its backward over 3 cotangent rows, under
    vjp + vmap, against the reference's custom VJP: within 1e-6 of max|.|,
    plus where the secant (f(x) - f(r)) / (x - r) is taken the float32
    cancellation it carries: 4 ulp of max(|f(x)|, |f(r)|) over |x - r|,
    times |g| (one ulp apart in erfc, JAX's and torch's GELU secants differ
    by 9e-5 of the value at |x - r| = 0.008)."""
    d = _dual_input(rng)
    ref_op = getattr(jds, f"{op}_rescale")
    port_op = getattr(ds, f"{op}_rescale")
    out_ref, pull = jax.vjp(ref_op, jnp.asarray(d))
    cts = rng.standard_normal((3,) + out_ref.shape).astype(np.float32)
    want = np.asarray(jax.vmap(lambda c: pull(c)[0])(jnp.asarray(cts)))

    out, port_pull = torch.func.vjp(port_op, torch.from_numpy(d))
    got = torch.func.vmap(lambda c: port_pull(c)[0])(torch.from_numpy(cts)).numpy()
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), rtol=0,
                               atol=1e-6 * np.abs(out_ref).max())
    assert got.shape == want.shape == (3, 2, 4, 10)
    assert not got[:, 1].any()  # the reference half's cotangent is zero
    if op == "glu":  # the secant is sigmoid's over the gate half, times (a + a_r) / 2
        gate = np.asarray(jax.nn.sigmoid(jnp.asarray(d[..., 5:])))
        delta = d[0, :, 5:] - d[1, :, 5:]
        scale = 0.5 * abs(d[0, :, :5] + d[1, :, :5])
        g = np.abs(cts[:, 0])
    else:
        gate, delta, scale, g = np.asarray(out_ref), d[0] - d[1], 1.0, np.abs(cts[:, 0])
    slack = np.where(abs(delta) > 1e-6, 4 * np.spacing(np.maximum(abs(gate[0]), abs(gate[1])))
                     / np.maximum(abs(delta), 1e-30) * scale, 0.0)
    if op == "glu":
        slack = np.concatenate([np.zeros_like(slack), slack], -1) * np.concatenate([g, g], -1)
    else:
        slack = slack * g
    err = np.abs(got[:, 0] - want[:, 0])
    assert (err <= 1e-6 * np.abs(want).max() + slack).all(), float(err.max())


def test_glu_rescale_is_the_exact_shapley_split(rng):
    """phi_a + phi_b = Delta(a * sig(b)) for each GLU output, with the
    two-player Shapley values of the product."""
    d = torch.from_numpy(rng.standard_normal((2, 6)).astype(np.float32))
    out, pull = torch.func.vjp(ds.glu_rescale, d)
    g = torch.func.vmap(lambda c: pull(c)[0])(torch.eye(3).reshape(3, 1, 3).expand(3, 2, 3)
                                              * torch.tensor([1.0, 0.0])[None, :, None])
    delta_in = d[0] - d[1]
    phi = g[:, 0] * delta_in                                    # [3 outputs, 6 inputs]
    a_x, b_x, a_r, b_r = d[0, :3], d[0, 3:], d[1, :3], d[1, 3:]
    phi_a = (a_x - a_r) * (torch.sigmoid(b_x) + torch.sigmoid(b_r)) / 2
    phi_b = (a_x + a_r) / 2 * (torch.sigmoid(b_x) - torch.sigmoid(b_r))
    torch.testing.assert_close(torch.diagonal(phi[:, :3]), phi_a, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(torch.diagonal(phi[:, 3:]), phi_b, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(phi.sum(dim=1), out[0] - out[1], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("family", ["wav2vec2", "w2v2-conformer"])
def test_deep_shap_values_match_reference(rng, family):
    """phi, base values and model output through each family's dual
    forward, 2 background rows, against the reference; and the dual
    forward's actual half against the plain forward."""
    if family == "wav2vec2":
        cfg = narrow_config()
        params, ref_params = shared_params(cfg, seed=5)
        ref_builder, port_builder = jds.wav2vec2_dual_fn, ds.wav2vec2_dual_fn
    else:
        cfg = narrow_conformer_config()
        params, ref_params = conformer_params(cfg, seed=5)
        ref_builder, port_builder = jds.w2v2_conformer_dual_fn, ds.w2v2_conformer_dual_fn
    ec = JaxExplainerConfig(method="deep", output_chunk=0, remat=False)
    x = rng.standard_normal(1600).astype(np.float32)
    bg = (0.01 * rng.standard_normal((2, 1600))).astype(np.float32)
    f_ref = ref_builder(ref_params, cfg, ec)
    ref = jax.jit(lambda a, b: jds.deep_shap_values(f_ref, a, b))(jnp.asarray(x),
                                                                  jnp.asarray(bg))

    pec = port_config.ExplainerConfig(**dataclasses.asdict(ec))
    f_dual = port_builder(params, port_cfg(cfg), pec)
    xt, bgt = torch.from_numpy(x), torch.from_numpy(bg)
    before = dict(LAUNCHES)
    out = ds.deep_shap_values(f_dual, xt, bgt)
    assert LAUNCHES == before  # the CPU path never launches a kernel
    phi_ref = np.asarray(ref.values)
    assert out.values.shape == phi_ref.shape == (1600, cfg.frames_for_samples(1600))
    # float32 through a 2-layer model and its batched backward: 2e-3 of max|phi|
    tol = 2e-3 * np.abs(phi_ref).max()
    np.testing.assert_allclose(out.values.numpy(), phi_ref, rtol=0, atol=tol)
    np.testing.assert_allclose(out.base_values.numpy(), np.asarray(ref.base_values),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(out.model_output.numpy(), np.asarray(ref.model_output),
                               rtol=0, atol=tol)
    with torch.no_grad():
        plain = make_explained_fn(params, port_cfg(cfg), pec)(xt)
        np.testing.assert_allclose(f_dual(ds.dual(xt, bgt[0])).numpy(), plain.numpy(),
                                   atol=1e-4, rtol=1e-3)
