"""The port's Wav2Vec2-Conformer (rel-pos, rotary and no positions) against
the reference package on the CPU: the relative-position helpers, logits of
the same params and audio, the trained conformer archive (logits and phi of
shared draws), and the pipeline's transcripts and confidence. The port runs
its kernel path (plain versions inside the kernels' Functions on the CPU).
Params and inputs are made by numpy from a seed and handed to both
packages."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.audio.normalize import zero_mean_unit_var as jax_normalize
from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.metrics import mean_max_softmax_confidence as jax_conf
from asr_shap.models.heads import aggregation_head as jax_head
from asr_shap.models.w2v2_conformer import init_w2v2_conformer_params, w2v2_conformer_logits
from asr_shap.ops.attention import rel_pos_embedding as jax_rel_pos_embedding
from asr_shap.ops.attention import rel_shift as jax_rel_shift
from asr_shap.ops.ctc import ctc_greedy_decode as jax_decode
from asr_shap.ops.ctc import ctc_ids_to_text as jax_ids_to_text
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import load_config, load_params
from asr_shap_torch.explain.expected_gradients import expected_gradients
from asr_shap_torch.kernels import LAUNCHES
from asr_shap_torch.models.heads import make_explained_fn, model_logits_fn
from asr_shap_torch.models.w2v2_conformer import (
    init_w2v2_conformer_params as port_init,
    w2v2_conformer_logits as port_logits,
)
from asr_shap_torch.ops.attention import rel_pos_embedding, rel_shift
from asr_shap_torch.pipeline.run_shap import run_shap_pipeline
from torch_port_configs import conformer_params, jax_draws, narrow_conformer_config, port_cfg

ARCHIVE = "artifacts/params_synthetic_conformer.npz"


def test_rel_pos_embedding_and_rel_shift_match_reference(rng):
    ref_table = jax.jit(jax_rel_pos_embedding, static_argnums=(0, 1))
    for t, d in ((1, 8), (37, 64)):
        np.testing.assert_allclose(rel_pos_embedding(t, d).numpy(),
                                   np.asarray(ref_table(t, d)), atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 3, 9, 17)).astype(np.float32)
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_rel_shift(jnp.asarray(x))))


# logits: atol 1e-4 / rtol 1e-3, as the port's Wav2Vec2 model tests (float32
# through 2 conformer layers, another summation order)
@pytest.mark.parametrize("position,padded", [
    ("relative", True), ("rotary", True), ("none", False)])
def test_logits_match_reference(rng, position, padded):
    """The reference runs its Pallas flash kernel in interpret mode; a
    padded batch makes the rel-pos bias carry -1e9 on the padded keys."""
    cfg = narrow_conformer_config(position_embeddings_type=position)
    params, ref_params = conformer_params(cfg, 0)
    x = rng.standard_normal((2, 1600)).astype(np.float32)
    lengths = np.array([1600, 1100]) if padded else None
    ref = np.asarray(jax.jit(lambda p, a, n: w2v2_conformer_logits(p, cfg, a, lengths=n))(
        ref_params, jnp.asarray(x), None if lengths is None else jnp.asarray(lengths)))
    before = dict(LAUNCHES)
    out = port_logits(params, port_cfg(cfg), torch.from_numpy(x),
                      lengths=None if lengths is None else torch.from_numpy(lengths))
    assert LAUNCHES == before
    assert out.shape == ref.shape == (2, cfg.frames_for_samples(1600), 32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-3)


def test_port_init_has_reference_layout():
    """The port's own init: the reference's tree (no pos_conv) and shapes,
    identity BatchNorm, zero u/v biases, and the forward the config
    selects."""
    cfg = narrow_conformer_config()
    ref = jax.eval_shape(lambda k: init_w2v2_conformer_params(k, cfg), jax.random.key(0))
    params = port_init(0, port_cfg(cfg), device="cpu")
    ref_layer = jax.tree.map(lambda s: s.shape[1:], ref["encoder"]["layers"])
    layer = jax.tree.map(lambda t: tuple(t.shape), params["encoder"]["layers"][1])
    assert layer == ref_layer
    assert len(params["encoder"]["layers"]) == cfg.num_hidden_layers
    assert params.keys() == ref.keys() and params["encoder"].keys() == ref["encoder"].keys()
    bn = params["encoder"]["layers"][0]["conv"]["bn"]
    assert bool((bn["var"] == 1).all()) and bool((bn["mean"] == 0).all())
    assert not params["encoder"]["layers"][0]["attn"]["bias_u"].any()
    assert model_logits_fn(port_cfg(cfg)) is port_logits


def test_archive_logits_and_phi_match_reference(rng):
    """The trained conformer archive read by both packages; the port runs it
    through the kernels' Functions (full-bias flash with d(bias) folded by
    the vmap rule), the reference through its plain math as saved. Logits
    at the draws' interpolation points; phi of explicit shared draws, the
    reference's as the expected-gradients mean of (x - background) times the
    Jacobian of its explained function, within 2e-3 of max|phi| as the
    Wav2Vec2 phi test."""
    cfg = jax_load_config(ARCHIVE)
    assert dataclasses.asdict(load_config(ARCHIVE)) == dataclasses.asdict(cfg)
    ref_params = jax_load_params(ARCHIVE)
    kcfg = dataclasses.replace(load_config(ARCHIVE), attention_impl="pallas",
                               conv_impl="pallas")
    params = load_params(ARCHIVE, device="cpu")
    assert len(params["encoder"]["layers"]) == 3
    assert tuple(params["encoder"]["layers"][0]["conv"]["depthwise"]["kernel"].shape) == (7, 1, 96)

    n = 3200
    x = rng.standard_normal(n).astype(np.float32)
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=1, output_chunk=0, num_background=3,
                            remat=False)
    bg = (0.01 * rng.standard_normal((3, n))).astype(np.float32)
    idx, ts = jax_draws(jax.random.key(7), 2, 3)
    diffs = x - bg[idx.numpy()]                                  # [draws, N]
    points = bg[idx.numpy()] + ts.numpy()[:, None] * diffs

    def f_ref(a):  # the reference's explained function, its logits as aux
        logits = w2v2_conformer_logits(ref_params, cfg, a[None])
        return jax_head(logits, ec.aggregation)[0], logits[0]

    # one program: at each draw's interpolation point, the Jacobian
    # [T_out, N] and the logits
    jacs, ref = jax.jit(jax.vmap(jax.jacrev(f_ref, has_aux=True)))(jnp.asarray(points))
    out = port_logits(params, kcfg, torch.from_numpy(points))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)
    want = (np.asarray(jacs) * diffs[:, None, :]).mean(axis=0).T

    pec = pc.ExplainerConfig(**dataclasses.asdict(ec))
    got = expected_gradients(make_explained_fn(params, kcfg, pec), torch.from_numpy(x),
                             torch.from_numpy(bg), config=pec, draws=(idx, ts))
    assert got.values.shape == want.shape == (n, cfg.frames_for_samples(n))
    np.testing.assert_allclose(got.values.numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_pipeline_matches_reference_forward(rng, tmp_path):
    """run_shap_pipeline on a conformer config on the CPU: the transcript and
    confidence of the reference's forward on the same params and audio."""
    cfg = narrow_conformer_config()
    params, ref_params = conformer_params(cfg, 1)
    n = 1600
    clean = np.sin(2 * np.pi * 220 * np.arange(n) / 16_000).astype(np.float32)
    noise = (0.3 * rng.standard_normal(n)).astype(np.float32)
    test_set = [{"type": "clean", "audio": clean, "noise": np.zeros_like(clean),
                 "text": "HELLO", "snr": float("inf")},
                {"type": "noisy", "audio": clean + noise, "noise": noise,
                 "text": "HELLO", "snr": 5.0}]
    pcfg = pc.PipelineConfig(model=port_cfg(cfg),
                             explainer=pc.ExplainerConfig(nsamples=1, draw_chunk=1, remat=False),
                             data_dir=str(tmp_path / "data"))
    results = run_shap_pipeline(params, pcfg, test_set, device="cpu")
    ref_logits = jax.jit(lambda a: w2v2_conformer_logits(ref_params, cfg,
                                                         jax_normalize(a)[None]))
    for sample, res in zip(test_set, results):
        logits = ref_logits(jnp.asarray(sample["audio"]))
        ids, keep = jax_decode(logits)
        assert res["transcription"] == jax_ids_to_text(np.asarray(ids[0]), np.asarray(keep[0]))
        assert abs(res["confidence"] - float(jax_conf(logits)[0])) < 1e-5
        phi = res["shap_values"]
        assert phi.shape == (n, cfg.frames_for_samples(n)) and np.isfinite(phi).all()
