"""The port's expected-gradients explainer against the reference package:
phi on a narrow Wav2Vec2 whose conv and attention go through the kernels'
Functions, with the reference's background and draws fed to the port; and
the analytic oracles of the reference's explainer tests."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain.expected_gradients import expected_gradients as jax_eg
from asr_shap.models import init_wav2vec2_params
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap_torch.core import config as port_config
from asr_shap_torch.core.params_io import params_from_jax
from asr_shap_torch.explain.expected_gradients import expected_gradients
from asr_shap_torch.kernels import LAUNCHES
from asr_shap_torch.models.heads import make_explained_fn
from torch_port_configs import jax_draws, narrow_config, port_cfg


def test_phi_matches_reference_with_shared_draws(rng):
    cfg = narrow_config()
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=1, output_chunk=0,
                            num_background=3, remat=False)
    params = init_wav2vec2_params(jax.random.key(0), cfg)
    x = rng.standard_normal(1600).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, 1600))).astype(np.float32)
    key = jax.random.key(7)
    f_ref = jax_make_f(params, cfg, ec)
    ref = jax.jit(lambda a, b, k: jax_eg(f_ref, a, b, k, ec))(
        jnp.asarray(x), jnp.asarray(bg), key)

    pec = port_config.ExplainerConfig(**dataclasses.asdict(ec))
    f = make_explained_fn(params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
                          port_cfg(cfg), pec)
    before = dict(LAUNCHES)
    out = expected_gradients(f, torch.from_numpy(x), torch.from_numpy(bg),
                             config=pec, draws=jax_draws(key, 2, 3))
    assert LAUNCHES == before  # the CPU path never launches a kernel
    phi_ref = np.asarray(ref.values)
    assert out.values.shape == phi_ref.shape == (1600, cfg.frames_for_samples(1600))
    # float32 through a 2-layer model and its batched backward: 2e-3 of
    # max|phi| for every entry
    scale = np.abs(phi_ref).max()
    np.testing.assert_allclose(out.values.numpy(), phi_ref, rtol=0, atol=2e-3 * scale)
    np.testing.assert_allclose(out.model_output.numpy(), np.asarray(ref.model_output),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out.base_values.numpy(), np.asarray(ref.base_values),
                               atol=1e-4, rtol=1e-3)


def test_linear_model_exact(rng):
    """f(x) = W^T x has a constant Jacobian, so phi = W * (x - b) exactly for
    one baseline, whatever the draws (twin of the reference's test)."""
    n, t = 16, 5
    w = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    f = lambda v: v @ w
    cfg = port_config.ExplainerConfig(nsamples=4, draw_chunk=2)
    res = expected_gradients(f, x, b, torch.Generator().manual_seed(0), cfg)
    expected = w.numpy() * (x - b[0]).numpy()[:, None]
    np.testing.assert_allclose(res.values.numpy(), expected, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.model_output.numpy(), f(x).numpy(), rtol=1e-6)
    np.testing.assert_allclose(res.base_values.numpy(), f(b[0]).numpy(), rtol=1e-5)


def test_output_chunking_identical(rng):
    """Chunked cotangent rows give the all-at-once Jacobian."""
    n, t = 12, 7
    a = torch.from_numpy(rng.standard_normal((n, t)).astype(np.float32))
    f = lambda v: torch.sin(v) @ a
    b = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    runs = [expected_gradients(f, x, b, torch.Generator().manual_seed(3),
                               port_config.ExplainerConfig(nsamples=8, draw_chunk=4,
                                                           output_chunk=oc))
            for oc in (0, 3)]
    np.testing.assert_allclose(runs[0].values.numpy(), runs[1].values.numpy(),
                               rtol=1e-5, atol=1e-7)
