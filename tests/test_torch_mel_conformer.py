"""The port's mel Conformer and NeMo BPE-CTC Conformer against the reference
package on the CPU: logits over positions x conv norm x subsampler, plain
and padded; a bf16 NeMo forward; expected-gradients phi of a NeMo model
from the reference's draws; DeepSHAP phi of the group-norm study variant;
the BPE decode; and archives carrying a ConformerConfig, saved by each
package and read by the other. The port runs its kernel path (plain
versions inside the kernels' Functions on the CPU), the reference its
Pallas kernels in interpret mode, each reference program jitted once.
Params and inputs are made by numpy from a seed."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import ConformerConfig as JaxConformerConfig
from asr_shap.core.config import TrainConfig as JaxTrainConfig
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.core.params_io import save_params as jax_save_params
from asr_shap.explain.deepshap import deep_shap_values as jax_deep_shap_values
from asr_shap.models.conformer import conformer_logits as jax_conformer_logits
from asr_shap.models.conformer import deepshap_rules as jax_deepshap_rules
from asr_shap.models.nemo_ctc import bpe_ids_to_text as jax_bpe_ids_to_text
from asr_shap.models.nemo_ctc import nemo_conformer_config as jax_nemo_config
from asr_shap.models.nemo_ctc import nemo_ctc_decode as jax_nemo_decode
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import load_config, load_params, params_to_jax, save_params
from asr_shap_torch.explain.deepshap import deep_shap_values
from asr_shap_torch.explain.expected_gradients import expected_gradients
from asr_shap_torch.kernels import LAUNCHES
from asr_shap_torch.models.conformer import (
    conformer_logits,
    deepshap_rules,
    init_conformer_params,
)
from asr_shap_torch.models.heads import aggregation_head
from asr_shap_torch.models.nemo_ctc import (
    bpe_ids_to_text,
    nemo_conformer_config,
    nemo_ctc_decode,
    nemo_ctc_logits,
)
from torch_port_configs import jax_draws, mel_conformer_params, port_cfg

T, F = 24, 16  # mel frames and bins of the tiny inputs


def tiny_config(**kw):
    """2 layers, 2 heads of 32 (a head dim the card's kernels take), 16
    mels, depthwise kernel 7, the kernel impl."""
    return JaxConformerConfig(**{**dict(
        vocab_size=17, input_dim=F, hidden_size=64, num_layers=2, num_attention_heads=2,
        ffn_expansion=2, conv_kernel_size=7, attention_impl="pallas"), **kw})


def tiny_nemo_config(**kw):
    return dataclasses.replace(
        jax_nemo_config(vocab_size=16, hidden_size=64, num_layers=2, num_attention_heads=2,
                        input_dim=F, conv_kernel_size=7), attention_impl="pallas", **kw)


def test_config_matches_reference():
    """Same fields, defaults and derived lengths; the NeMo preset and the
    training config too."""
    assert dataclasses.asdict(pc.ConformerConfig()) == dataclasses.asdict(JaxConformerConfig())
    assert dataclasses.asdict(pc.TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    assert ([f.name for f in dataclasses.fields(pc.TrainConfig)]
            == [f.name for f in dataclasses.fields(JaxTrainConfig)])
    cfg = nemo_conformer_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_nemo_config())
    assert (cfg.head_dim, cfg.subsampling_layers, cfg.subsampled_length(301)) == (64, 2, 76)


# logits: atol 1e-4 / rtol 1e-3, as the port's other model tests (float32
# through 2 layers, another summation order)
@pytest.mark.parametrize("subsampling", ["none", "striding"])
@pytest.mark.parametrize("conv_norm", ["batch", "group"])
@pytest.mark.parametrize("position", ["none", "relative"])
def test_logits_match_reference(rng, position, conv_norm, subsampling):
    """One clip, and a padded batch of two whose lengths (in output frames)
    make the mask, or the rel-pos bias, carry -1e9 on the padded keys."""
    cfg = tiny_config(pos_encoding=position, conv_norm=conv_norm, num_conv_groups=2,
                      subsampling=subsampling, input_scale=subsampling == "striding")
    params, tree = mel_conformer_params(cfg, 0)
    x = rng.standard_normal((2, T, F)).astype(np.float32)
    t_out = cfg.subsampled_length(T) if subsampling == "striding" else T
    lengths = np.array([t_out, t_out - 2])

    @jax.jit
    def reference(p, a, n):
        return (jax_conformer_logits(p, cfg, a[0]),
                jax_conformer_logits(p, cfg, a, lengths=n))

    single, padded = (np.asarray(v) for v in reference(tree, jnp.asarray(x),
                                                       jnp.asarray(lengths)))
    pcfg = port_cfg(cfg)
    before = dict(LAUNCHES)
    got_single = conformer_logits(params, pcfg, torch.from_numpy(x[0]))
    got_padded = conformer_logits(params, pcfg, torch.from_numpy(x),
                                  lengths=torch.from_numpy(lengths))
    assert LAUNCHES == before
    assert got_single.shape == single.shape == (t_out, 17)
    assert got_padded.shape == padded.shape == (2, t_out, 17)
    np.testing.assert_allclose(got_single.numpy(), single, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_padded.numpy(), padded, atol=1e-4, rtol=1e-3)


def test_port_init_has_reference_layout():
    """The port's own init: the reference's tree and shapes (the NeMo
    preset's subsampler, rel-pos u/v), zero u/v, identity BatchNorm."""
    from asr_shap.models.conformer import init_conformer_params as jax_init

    for cfg in (tiny_nemo_config(), tiny_config(input_dim=20)):
        ref = jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.key(0))
        params = init_conformer_params(0, port_cfg(cfg), device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), params_to_jax(params)) == \
            jax.tree.map(lambda s: tuple(s.shape), ref)
        layer = params["layers"][0]
        assert not layer["attn"].get("bias_u", torch.zeros(1)).any()
        assert bool((layer["conv"]["bn"]["var"] == 1).all())


def test_bf16_nemo_logits_match_reference(rng):
    """bf16 through the kernels' Functions: as close to the reference's
    float32 logits as the reference's own bf16 logits (the mean error at
    most twice theirs), and within 5% of max|logit| of them, as the bf16
    Wav2Vec2-Conformer test; padded at B = 2."""
    cfg32 = tiny_nemo_config()
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params, tree = mel_conformer_params(cfg32, 2)
    x = rng.standard_normal((2, T, F)).astype(np.float32)
    n = np.array([6, 4])

    @jax.jit
    def reference(p, a, n_):
        return [jax_conformer_logits(p, c, a, lengths=n_) for c in (cfg16, cfg32)]

    jax16, jax32 = (np.asarray(v) for v in reference(tree, jnp.asarray(x), jnp.asarray(n)))
    port16 = nemo_ctc_logits(params, port_cfg(cfg16), torch.from_numpy(x),
                             lengths=torch.from_numpy(n))
    assert port16.dtype == torch.float32 and port16.shape == jax16.shape
    port16 = port16.numpy()
    ref_err = np.abs(jax16 - jax32).mean()
    assert 0 < ref_err
    assert np.abs(port16 - jax32).mean() <= 2 * ref_err
    assert np.abs(port16 - jax16).max() <= 0.05 * np.abs(jax32).max()


def test_nemo_phi_matches_reference_with_shared_draws(rng):
    """Expected gradients over the flattened log-mel input of a tiny NeMo
    model, f = the max over vocab of each output frame, from the
    reference's draws: the reference's phi as the mean of (x - background)
    times its Jacobian at each draw's point, within 2e-3 of max|phi|."""
    cfg = tiny_nemo_config()
    params, tree = mel_conformer_params(cfg, 3)
    n = T * F
    x = rng.standard_normal(n).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, n))).astype(np.float32)
    idx, ts = jax_draws(jax.random.key(7), 2, 3)
    diffs = x - bg[idx.numpy()]
    points = bg[idx.numpy()] + ts.numpy()[:, None] * diffs

    def f_ref(a):
        return jnp.max(jax_conformer_logits(tree, cfg, a.reshape(T, F)), axis=-1)

    jacs = jax.jit(jax.vmap(jax.jacrev(f_ref)))(jnp.asarray(points))
    want = (np.asarray(jacs) * diffs[:, None, :]).mean(axis=0).T

    pcfg = port_cfg(cfg)

    def f(a):
        return aggregation_head(nemo_ctc_logits(params, pcfg, a.reshape(T, F)), "max")

    ec = pc.ExplainerConfig(nsamples=2, draw_chunk=1, num_background=3)
    got = expected_gradients(f, torch.from_numpy(x), torch.from_numpy(bg), config=ec,
                             draws=(idx, ts))
    assert got.values.shape == want.shape == (n, cfg.subsampled_length(T))
    np.testing.assert_allclose(got.values.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_deepshap_matches_reference(rng):
    """DeepSHAP on the group-norm study variant (SiLU and GLU rescale, the
    dual pair as the batch axis) against the reference's deep_shap_values,
    within 2e-3 of max|phi|."""
    cfg = tiny_config(conv_norm="group", num_conv_groups=1, vocab_size=32)
    params, tree = mel_conformer_params(cfg, 4)
    t = 12
    x = rng.standard_normal(t * F).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, t * F))).astype(np.float32)

    def jax_f_dual(d):
        logits = jax_conformer_logits(tree, cfg, d.reshape(2, t, F), rules=jax_deepshap_rules())
        return jnp.max(logits[0], axis=-1)

    want = np.asarray(jax.jit(lambda a, b: jax_deep_shap_values(jax_f_dual, a, b).values)(
        jnp.asarray(x), jnp.asarray(bg)))
    pcfg = port_cfg(cfg)

    def f_dual(d):
        logits = conformer_logits(params, pcfg, d.reshape(2, t, F), rules=deepshap_rules())
        return logits[0].amax(dim=-1)

    got = deep_shap_values(f_dual, torch.from_numpy(x), torch.from_numpy(bg))
    assert got.values.shape == want.shape == (t * F, t)
    np.testing.assert_allclose(got.values.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


def test_bpe_decode_matches_reference(rng):
    """Greedy BPE-CTC decode (blank last) with and without lengths, and the
    sentencepiece text assembly."""
    vocab = ["▁the", "▁cat", "s", "▁sat", "▁on", "▁a", "▁mat"]
    logits = rng.standard_normal((3, 20, len(vocab) + 1)).astype(np.float32)
    logits[:, ::3, -1] += 3.0  # some blanks
    for lengths in (None, [20, 11, 3]):
        assert nemo_ctc_decode(torch.from_numpy(logits), vocab, lengths) == \
            jax_nemo_decode(jnp.asarray(logits), vocab, lengths)
    ids, keep = np.array([0, 1, 2, 3, 0]), np.array([True, True, True, True, False])
    assert bpe_ids_to_text(torch.from_numpy(ids), torch.from_numpy(keep), vocab) == \
        jax_bpe_ids_to_text(ids, keep, vocab) == "the cats sat"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_conformer_archive_loads_in_both_packages(tmp_path, writer):
    """An archive embedding a ConformerConfig (the NeMo preset, bf16) saved
    by one package reads back in the other: the same config, the same
    leaves (layers stacked in the file, one dict per layer in the port)."""
    cfg = dataclasses.replace(tiny_nemo_config(), dtype="bfloat16")
    params, tree = mel_conformer_params(cfg, 5)
    path = str(tmp_path / "mel.npz")
    if writer == "port":
        save_params(path, params, port_cfg(cfg))
        assert jax_load_config(path) == cfg
        got = jax_load_params(path)
    else:
        jax_save_params(path, jax.tree.map(jnp.asarray, tree), cfg)
        assert load_config(path) == port_cfg(cfg)
        loaded = load_params(path, device="cpu")
        assert len(loaded["layers"]) == cfg.num_layers
        assert isinstance(loaded["subsampling"]["convs"], list)
        got = params_to_jax(loaded)
    assert jax.tree.structure(got) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
