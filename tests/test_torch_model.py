"""The port's model, params archives and normalization against the reference
package, on the CPU: same weights (carried by params_from_jax), same audio
made by numpy from a seed."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.audio.normalize import zero_mean_unit_var as jax_normalize
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.models import init_wav2vec2_params, wav2vec2_logits
from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core import config as port_config
from asr_shap_torch.core.params_io import load_config, load_params, params_from_jax
from asr_shap_torch.models.wav2vec2 import wav2vec2_logits as port_logits
from torch_port_configs import narrow_config, port_cfg

STUDY = "artifacts/params_synthetic_study.npz"


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# logits: atol 1e-4 / rtol 1e-3 (float32 through 2 encoder layers; the
# reference's own pallas-vs-xla model test uses the same)
@pytest.mark.parametrize("which", ["tiny", "narrow_pallas"])
def test_logits_match_reference(rng, tiny_config, which):
    cfg = tiny_config if which == "tiny" else narrow_config()
    params = init_wav2vec2_params(jax.random.key(0), cfg)
    x = rng.standard_normal((2, 1600)).astype(np.float32)
    ref = np.asarray(wav2vec2_logits(params, cfg, jnp.asarray(x)))
    out = port_logits(params_from_jax(_np_tree(params), device="cpu"),
                      port_cfg(cfg), torch.from_numpy(x))
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("stable", [False, True])
def test_padded_batch_logits_match_reference(rng, tiny_config, stable):
    """The lengths path (frame mask and the -1e9 key bias), with the
    layer-norm feature encoder, post-LN and stable (pre-LN) layers."""
    cfg = dataclasses.replace(tiny_config, feat_extract_norm="layer",
                              do_stable_layer_norm=stable)
    params = init_wav2vec2_params(jax.random.key(1), cfg)
    x = rng.standard_normal((2, 1600)).astype(np.float32)
    lengths = np.array([1600, 1100])
    ref = np.asarray(wav2vec2_logits(params, cfg, jnp.asarray(x),
                                     lengths=jnp.asarray(lengths)))
    out = port_logits(params_from_jax(_np_tree(params), device="cpu"),
                      port_cfg(cfg), torch.from_numpy(x),
                      lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)


def test_study_archive_loads_like_reference():
    ref_params = jax_load_params(STUDY)
    params = load_params(STUDY, device="cpu")
    assert dataclasses.asdict(load_config(STUDY)) == dataclasses.asdict(
        jax_load_config(STUDY))
    layers = params["encoder"]["layers"]
    assert len(layers) == 3
    np.testing.assert_array_equal(
        layers[2]["attention"]["q"]["kernel"].numpy(),
        np.asarray(ref_params["encoder"]["layers"]["attention"]["q"]["kernel"][2]))
    np.testing.assert_array_equal(
        params["feature_encoder"][0]["conv"]["kernel"].numpy(),
        np.asarray(ref_params["feature_encoder"][0]["conv"]["kernel"]))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_normalize_matches_reference(rng, with_lengths):
    x = (rng.standard_normal((3, 500)) * 3 + 1).astype(np.float32)
    lengths = np.array([500, 321, 7]) if with_lengths else None
    ref = jax_normalize(jnp.asarray(x),
                        None if lengths is None else jnp.asarray(lengths))
    out = zero_mean_unit_var(torch.from_numpy(x),
                             None if lengths is None else torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_model_leaves_tf32_switches_alone(tiny_config):
    """"highest" and "default" are ported, any other precision raises; the
    model sets no process-wide switch, and highest_precision() restores the
    switches it found."""
    from asr_shap_torch.core.device import highest_precision, tf32_enabled

    params = params_from_jax(_np_tree(init_wav2vec2_params(jax.random.key(0),
                                                           tiny_config)), "cpu")
    x = torch.zeros(1, 1600)
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        port_logits(params, port_cfg(dataclasses.replace(
            tiny_config, matmul_precision="fastest")), x)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        port_logits(params, port_cfg(tiny_config), x)
        port_logits(params, port_cfg(dataclasses.replace(
            tiny_config, matmul_precision="default")), x)
        assert tf32_enabled()
        with highest_precision():
            assert not tf32_enabled()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params as port_init

    with pytest.raises(RuntimeError, match="CUDA"):
        port_init(0, port_config.Wav2Vec2Config(num_hidden_layers=1))
