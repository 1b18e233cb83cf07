"""The port's KernelSHAP and LIME against the reference package on the narrow
Wav2Vec2 (kernel Functions on the path, the reference in interpret mode),
fed the reference's coalitions; the port's own coalition sampler; and the
deep, kernel and lime branches of the pipeline against the reference's
pipeline step, fed that step's background and coalitions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.core.config import PipelineConfig as JaxPipelineConfig
from asr_shap.core.prng import fold
from asr_shap.explain.baselines import zeros_noise_background as jax_background
from asr_shap.explain.kernel_shap import _sample_coalitions
from asr_shap.explain.kernel_shap import kernel_shap_attributions as jax_kernel_shap
from asr_shap.explain.lime import lime_attributions as jax_lime
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap.pipeline.run_shap import _sample_step
from asr_shap_torch.core import config as pc
from asr_shap_torch.explain.kernel_shap import kernel_shap_attributions, sample_coalitions
from asr_shap_torch.explain.lime import lime_attributions
from asr_shap_torch.models.heads import make_batched_fn
from asr_shap_torch.pipeline.run_shap import explain_phi
from torch_port_configs import jax_lime_masks, narrow_config, port_cfg, shared_params


def _close(got, want, what):
    """2e-3 of max|want|: float32 forwards of a 2-layer model in another
    summation order, through a small least-squares solve."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module")
def narrow_model():
    cfg = narrow_config()
    params, ref_params = shared_params(cfg, seed=6)
    ec = JaxExplainerConfig(remat=False)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1600).astype(np.float32)
    baseline = (0.01 * rng.standard_normal(1600)).astype(np.float32)
    f_batch = make_batched_fn(params, port_cfg(cfg), pc.ExplainerConfig(remat=False))
    return jax_make_f(ref_params, cfg, ec), f_batch, x, baseline


@pytest.mark.parametrize("mode", ["enumerate_all", "sampled"])
def test_kernel_shap_matches_reference(narrow_model, mode):
    """S = 6 with all 62 coalitions (exact Shapley values of the segment
    game), and S = 8 with the reference's 20 sampled coalitions."""
    f_ref, f_batch, x, b = narrow_model
    key = jax.random.key(3)
    if mode == "enumerate_all":
        kw, masks = dict(num_segments=6, enumerate_all=True), None
    else:
        kw = dict(num_segments=8, num_samples=20)
        masks = torch.from_numpy(np.asarray(_sample_coalitions(key, 8, 20)))
    ref = jax.jit(lambda a, bb: jax_kernel_shap(f_ref, a, key, baseline=bb, **kw))(
        jnp.asarray(x), jnp.asarray(b))
    got = kernel_shap_attributions(f_batch, torch.from_numpy(x), baseline=torch.from_numpy(b),
                                   masks=masks, **kw)
    _close(got.segment_values, ref.segment_values, "segment values")
    _close(got.base_value, ref.base_value, "base value")
    _close(got.model_output, ref.model_output, "model output")
    _close(got.values, ref.values, "values")
    # efficiency, by construction
    np.testing.assert_allclose(got.segment_values.sum(0).numpy(),
                               (got.model_output - got.base_value).numpy(), atol=1e-5)


def test_lime_matches_reference(narrow_model):
    f_ref, f_batch, x, b = narrow_model
    key = jax.random.key(4)
    ref = jax.jit(lambda a, bb: jax_lime(f_ref, a, key, num_segments=8, num_samples=20,
                                         baseline=bb))(jnp.asarray(x), jnp.asarray(b))
    got = lime_attributions(f_batch, torch.from_numpy(x), num_segments=8, num_samples=20,
                            baseline=torch.from_numpy(b),
                            masks=jax_lime_masks(key, 20, 8))
    _close(got.segment_values, ref.segment_values, "segment values")
    _close(got.intercept, ref.intercept, "intercept")
    _close(got.model_output, ref.model_output, "model output")
    _close(got.values, ref.values, "values")


@pytest.mark.parametrize("num_samples", [9, 40])
def test_sample_coalitions_are_paired_and_proper(num_samples):
    s = 7
    masks = sample_coalitions(torch.Generator().manual_seed(num_samples), s, num_samples)
    half = num_samples // 2
    assert masks.shape == (num_samples, s) and masks.dtype == torch.float32
    assert set(masks.unique().tolist()) <= {0.0, 1.0}
    sizes = masks[:half].sum(1)
    assert bool(((sizes >= 1) & (sizes <= s - 1)).all())
    assert torch.equal(masks[half:2 * half], 1.0 - masks[:half])
    if num_samples % 2:
        assert torch.equal(masks[-1], masks[0])
    again = sample_coalitions(torch.Generator().manual_seed(num_samples), s, num_samples)
    assert torch.equal(masks, again)


def test_kernel_shap_exact_on_an_additive_model(rng):
    """f(x) = x @ W is additive over segments, so every regime returns each
    segment's exact contribution sum_{n in seg} W[n] (x_n - b_n)."""
    n, t, s = 30, 4, 5
    w = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = ((x - b)[:, None] * w).reshape(s, n // s, t).sum(1)
    for kw in (dict(enumerate_all=True), dict(num_samples=64)):
        got = kernel_shap_attributions(lambda xs: xs @ w, x, torch.Generator().manual_seed(1),
                                       num_segments=s, baseline=b, **kw)
        torch.testing.assert_close(got.segment_values, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("method", ["deep", "kernel", "lime"])
def test_pipeline_step_matches_reference(rng, tiny_config, method):
    """phi of one sample through the port's pipeline branch against the
    reference's pipeline step, fed the step's background (fold(key, 0)) and
    coalitions (fold(key, 1))."""
    ec = JaxExplainerConfig(method=method, num_background=2, output_chunk=0, remat=False,
                            nsamples=10, kernel_num_segments=5, lime_num_samples=10,
                            lime_num_segments=5)
    params, ref_params = shared_params(tiny_config, seed=7)
    x = rng.standard_normal(800).astype(np.float32)
    x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
    key = fold(jax.random.key(0), 3)  # sample 3 of a run with seed 0
    want = jax.jit(_sample_step(JaxPipelineConfig(model=tiny_config, explainer=ec)))(
        ref_params, jnp.asarray(x), key)[0]

    bg = torch.from_numpy(np.asarray(jax_background(fold(key, 0), 800, 2, 0.01)))
    masks = None
    if method == "kernel":
        masks = torch.from_numpy(np.asarray(_sample_coalitions(fold(key, 1), 5, 10)))
    elif method == "lime":
        masks = jax_lime_masks(fold(key, 1), 10, 5)
    pcfg = pc.PipelineConfig(model=port_cfg(tiny_config),
                             explainer=pc.ExplainerConfig(**dataclasses.asdict(ec)))
    got = explain_phi(params, pcfg, torch.from_numpy(x), bg, masks=masks)
    assert got.shape == want.shape == (800, tiny_config.frames_for_samples(800))
    _close(got, want, f"phi ({method})")
