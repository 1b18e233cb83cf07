"""The feature encoder's conv formulations conv_impl="gemm" (stride-blocked
GEMMs both ways) and "hybrid" (the library conv forward, the GEMM backward)
against the reference's same impls on the CPU: logits of both Wav2Vec2
families, phi of shared draws, and the hybrid Function under vmap."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain.expected_gradients import expected_gradients as jax_eg
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap.models.w2v2_conformer import w2v2_conformer_logits as jax_conformer_logits
from asr_shap.models.wav2vec2 import wav2vec2_logits as jax_logits
from asr_shap_torch.core import config as port_config
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.models.heads import make_explained_fn, model_logits_fn
from asr_shap_torch.models.wav2vec2 import Conv1dHybrid, _conv1d
from torch_port_configs import (
    conformer_params,
    jax_draws,
    narrow_conformer_config,
    narrow_config,
    port_cfg,
    shared_params,
)


# logits: atol 1e-4 / rtol 1e-3, as the port's model tests (float32 through
# 2 layers, another summation order)
@pytest.mark.parametrize("family", ["wav2vec2", "w2v2-conformer"])
@pytest.mark.parametrize("impl", ["gemm", "hybrid"])
def test_logits_match_reference_impl(rng, family, impl):
    if family == "wav2vec2":
        cfg = dataclasses.replace(narrow_config(), conv_impl=impl, attention_impl="xla")
        params, ref_params = shared_params(cfg)
        ref_fn = jax_logits
    else:
        cfg = narrow_conformer_config(conv_impl=impl, attention_impl="xla")
        params, ref_params = conformer_params(cfg, 0)
        ref_fn = jax_conformer_logits
    x = rng.standard_normal((2, 1603)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a: ref_fn(p, cfg, a))(ref_params, jnp.asarray(x)))
    out = model_logits_fn(port_cfg(cfg))(params, port_cfg(cfg), torch.from_numpy(x))
    assert out.shape == ref.shape == (2, cfg.frames_for_samples(1603), 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("impl", ["gemm", "hybrid"])
def test_phi_matches_reference_impl(rng, impl):
    """phi of two shared draws through the formulation's backward, within
    2e-3 of max|phi| as tests/test_torch_explain.py holds the kernel path."""
    cfg = dataclasses.replace(narrow_config(), conv_impl=impl, attention_impl="xla")
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=1, output_chunk=0, num_background=3,
                            remat=False)
    params, ref_params = shared_params(cfg, seed=1)
    x = rng.standard_normal(1600).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, 1600))).astype(np.float32)
    key = jax.random.key(7)
    f_ref = jax_make_f(ref_params, cfg, ec)
    ref = np.asarray(jax.jit(lambda a, b, k: jax_eg(f_ref, a, b, k, ec).values)(
        jnp.asarray(x), jnp.asarray(bg), key))
    pec = port_config.ExplainerConfig(**dataclasses.asdict(ec))
    phi = expected_phi(make_explained_fn(params, port_cfg(cfg), pec), torch.from_numpy(x),
                       torch.from_numpy(bg), config=pec, draws=jax_draws(key, 2, 3))
    assert phi.shape == ref.shape == (1600, cfg.frames_for_samples(1600))
    np.testing.assert_allclose(phi.numpy(), ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_hybrid_under_vmap_equals_its_rows(rng):
    """The explainer's batched VJP: the cotangent rows vmapped through the
    hybrid Function's generated rule give each row's own VJP, and the
    formulations agree with the library conv's gradients."""
    x = torch.from_numpy(rng.standard_normal((1, 403, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 6, 5)).astype(np.float32))
    y, vjp = torch.func.vjp(lambda v: Conv1dHybrid.apply(v, w, 2), x)
    rows = torch.from_numpy(rng.standard_normal((7,) + tuple(y.shape)).astype(np.float32))
    batched = torch.func.vmap(lambda c: vjp(c)[0])(rows)
    one_by_one = torch.stack([vjp(c)[0] for c in rows])
    torch.testing.assert_close(batched, one_by_one, rtol=0, atol=0)
    for impl in ("gemm", "hybrid"):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = _conv1d(xg, wg, stride=2, impl=impl)
        grads = torch.autograd.grad(out, (xg, wg), rows[0])
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        want = torch.autograd.grad(_conv1d(xl, wl, stride=2, impl="lax"), (xl, wl), rows[0])
        for g, h in zip(grads, want):
            torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-5)
