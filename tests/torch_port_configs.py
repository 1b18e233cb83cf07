"""Configurations and helpers shared by the port's parity tests
(tests/test_torch_*.py). Imported by module name: pytest puts this
directory on sys.path for the test modules beside it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from asr_shap.core.config import Wav2Vec2Config as JaxWav2Vec2Config
from asr_shap.core.config import Wav2Vec2ConformerConfig as JaxWav2Vec2ConformerConfig
from asr_shap_torch.core import config as port_config


def narrow_config(**kw):
    """Conv widths of 128, so the dgrad kernel's Function is on the path;
    the projection's norm width is the last conv width."""
    return JaxWav2Vec2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=128, conv_dim=(128, 128, 128), conv_stride=(5, 2, 2),
        conv_kernel=(10, 3, 2), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, feat_proj_dim=128,
        attention_impl="pallas", conv_impl="pallas", **kw)


def narrow_conformer_config(**kw):
    """The rel-pos conformer at narrow widths: 2 layers, 2 heads of 32,
    conv widths of 128 (the dgrad kernel's Function is on the path), conv
    bias, layer-norm feature encoder, depthwise kernel 7, kernel impls."""
    return JaxWav2Vec2ConformerConfig(**{
        **dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, conv_dim=(128, 128, 128), conv_stride=(5, 2, 2),
               conv_kernel=(10, 3, 2), feat_proj_dim=128, conv_depthwise_kernel_size=7,
               attention_impl="pallas", conv_impl="pallas"),
        **kw})


def bf16_pair(a):
    """numpy float32 -> (the same values rounded to bf16 as a jnp array, and
    as a torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def port_cfg(cfg):
    """The port's twin of a reference model config (same class name)."""
    return getattr(port_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def jax_draws(key, total, num_background):
    """The reference's per-draw (background index, t): fold_in per global
    draw, then split (asr_shap/explain/expected_gradients.py:88-91, :109),
    as tensors the port's explainer takes. One jitted program: the same
    values as the reference's per-draw calls."""

    @jax.jit
    def draws(k):
        kb, kt = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(k, i)))(
            jnp.arange(total)).T
        return (jax.vmap(lambda kk: jax.random.randint(kk, (), 0, num_background))(kb),
                jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float32))(kt))

    idx, ts = draws(key)
    return (torch.from_numpy(np.array(idx, np.int64)),
            torch.from_numpy(np.array(ts, np.float32)))


def jax_lime_masks(key, num_samples, num_segments, keep_prob=0.5):
    """The reference LIME's coalitions under ``key`` (asr_shap/explain/lime.py),
    as a tensor the port's LIME takes."""
    (k_mask,) = jax.random.split(key, 1)
    masks = jax.random.bernoulli(k_mask, keep_prob, (num_samples, num_segments))
    return torch.from_numpy(np.asarray(masks.astype(jnp.float32).at[0].set(1.0)))


def shared_params(cfg, seed=0):
    """Wav2Vec2 params drawn by numpy through the port's init: (port params
    on the CPU, the same values as the reference's tree of jnp arrays,
    encoder layers stacked)."""
    from asr_shap_torch.core.params_io import params_to_jax
    from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params

    params = init_wav2vec2_params(seed, port_cfg(cfg), device="cpu")
    return params, jax.tree.map(jnp.asarray, params_to_jax(params))


def conformer_params(cfg, seed):
    """Wav2Vec2-Conformer params drawn by numpy through the port's init, with
    non-trivial u/v biases and BatchNorm statistics: (port params on the
    CPU, the same values as the reference's tree of numpy arrays, encoder
    layers stacked)."""
    from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params

    params = init_w2v2_conformer_params(seed, port_cfg(cfg), device="cpu")
    randomize_layers(params["encoder"]["layers"], np.random.default_rng(seed + 1))
    tree = jax.tree.map(lambda t: t.numpy(), params)
    tree["encoder"]["layers"] = jax.tree.map(lambda *xs: np.stack(xs),
                                             *tree["encoder"]["layers"])
    return params, tree


def mel_conformer_params(cfg, seed):
    """Mel Conformer params drawn by numpy through the port's init, with
    non-trivial u/v biases (rel-pos configs) and BatchNorm statistics and
    affines: (port params on the CPU, the same values as the reference's
    tree of numpy arrays, layers stacked)."""
    from asr_shap_torch.core.params_io import params_to_jax
    from asr_shap_torch.models.conformer import init_conformer_params

    params = init_conformer_params(seed, port_cfg(cfg), device="cpu")
    randomize_layers(params["layers"], np.random.default_rng(seed + 1))
    return params, params_to_jax(params)


def randomize_layers(layers, rng):
    """In place: each conformer layer's u/v biases (rel-pos layers) and
    BatchNorm statistics and affine drawn from ``rng``, where the port's
    init leaves zeros and identities."""

    def fill(t, lo, hi):
        t.copy_(torch.from_numpy(rng.uniform(lo, hi, tuple(t.shape)).astype(np.float32)))

    for layer in layers:
        for name in ("bias_u", "bias_v"):
            if name in layer["attn"]:
                fill(layer["attn"][name], -0.5, 0.5)
        bn = layer["conv"]["bn"]
        for name, lo, hi in (("mean", -0.2, 0.2), ("var", 0.5, 1.5), ("scale", 0.5, 1.5),
                             ("bias", -0.2, 0.2)):
            fill(bn[name], lo, hi)
