"""The port's pipeline, decode and metrics against the reference package on
the CPU: transcripts and confidence of the same params and audio, a store
the reference reads, and eta_raw / WER of the same phi."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.audio.normalize import zero_mean_unit_var as jax_normalize
from asr_shap.core.config import MetricConfig as JaxMetricConfig
from asr_shap.core.store import AttributionStore as JaxStore
from asr_shap.core.store import key_for as jax_key_for
from asr_shap.metrics import eta_raw as jax_eta_raw
from asr_shap.metrics import mean_max_softmax_confidence as jax_conf
from asr_shap.metrics import wer as jax_wer
from asr_shap.models import init_wav2vec2_params, wav2vec2_logits
from asr_shap.ops.ctc import ctc_greedy_decode as jax_decode
from asr_shap.ops.ctc import ctc_ids_to_text as jax_ids_to_text
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import params_from_jax
from asr_shap_torch.metrics.eta_raw import eta_raw
from asr_shap_torch.metrics.wer import wer
from asr_shap_torch.ops.ctc import ctc_greedy_decode, ctc_ids_to_text
from asr_shap_torch.pipeline.run_shap import run_shap_pipeline
from torch_port_configs import port_cfg


def _test_set(rng, n=1600):
    t = np.arange(n) / 16_000
    clean = (np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
             ).astype(np.float32)
    noise = (rng.standard_normal(n) * np.sqrt(np.mean(clean ** 2) / 10 ** 0.5)
             ).astype(np.float32)
    return [
        {"type": "clean", "audio": clean, "noise": np.zeros_like(clean),
         "text": "HELLO WORLD", "snr": float("inf")},
        {"type": "noisy", "audio": clean + noise, "noise": noise,
         "text": "HELLO WORLD", "snr": 5.0},
    ]


def test_pipeline_matches_reference(rng, tmp_path, tiny_config):
    params = init_wav2vec2_params(jax.random.key(0), tiny_config)
    test_set = _test_set(rng)
    cfg = pc.PipelineConfig(
        model=port_cfg(tiny_config),
        explainer=pc.ExplainerConfig(nsamples=2, draw_chunk=1, remat=False),
        data_dir=str(tmp_path / "data"))
    results = run_shap_pipeline(
        params_from_jax(jax.tree.map(np.asarray, params), "cpu"), cfg, test_set,
        device="cpu")
    assert [r["index"] for r in results] == [0, 1]

    store = JaxStore(str(tmp_path / "data"))
    ref_logits = jax.jit(lambda a: wav2vec2_logits(params, tiny_config,
                                                   jax_normalize(a)[None]))
    for i, (sample, res) in enumerate(zip(test_set, results)):
        logits = ref_logits(jnp.asarray(sample["audio"]))
        ids, keep = jax_decode(logits)
        assert res["transcription"] == jax_ids_to_text(np.asarray(ids[0]),
                                                       np.asarray(keep[0]))
        assert abs(res["confidence"] - float(jax_conf(logits)[0])) < 1e-5

        key = jax_key_for(i, sample["type"], sample["snr"])
        assert store.completed(key)
        stored = store.load(key)
        phi = stored["shap_values"]
        assert phi.shape == (1600, tiny_config.frames_for_samples(1600))
        assert np.isfinite(phi).all() and np.abs(phi).max() > 0
        np.testing.assert_array_equal(phi, res["shap_values"])
        np.testing.assert_array_equal(stored["audio"], sample["audio"])
        assert stored["text"] == sample["text"]

        clean = sample["audio"] - sample["noise"]
        for variant in ("strict", "half"):
            want = float(jax_eta_raw(jnp.asarray(clean), jnp.asarray(sample["noise"]),
                                     jnp.asarray(phi),
                                     JaxMetricConfig(itm_variant=variant)))
            got = float(eta_raw(torch.from_numpy(clean),
                                torch.from_numpy(sample["noise"]),
                                torch.from_numpy(phi),
                                pc.MetricConfig(itm_variant=variant)))
            assert got == pytest.approx(want, abs=1e-6)
        hyp = res["transcription"]
        assert wer(sample["text"], hyp) == jax_wer(sample["text"], hyp)

    # resume: every sample is in the store, so nothing is recomputed
    assert run_shap_pipeline(None, cfg, test_set, device="cpu") == []


def test_eta_raw_transposed_and_tied_inputs(rng):
    clean = rng.standard_normal(4000).astype(np.float32)
    noise = (rng.standard_normal(4000) * 0.8).astype(np.float32)
    phi = rng.standard_normal((4000, 12)).astype(np.float32)
    tied = np.repeat(rng.standard_normal(40), 100).astype(np.float32)
    for m in (phi, phi.T, tied):
        want = float(jax_eta_raw(jnp.asarray(clean), jnp.asarray(noise), jnp.asarray(m)))
        got = float(eta_raw(torch.from_numpy(clean), torch.from_numpy(noise),
                            torch.from_numpy(np.ascontiguousarray(m))))
        assert got == pytest.approx(want, abs=1e-6)


def test_ctc_decode_matches_reference(rng):
    logits = rng.standard_normal((3, 40, 32)).astype(np.float32)
    logits[0, :, 0] += 5.0  # all blank
    logits[1, 5:15, 7] += 9.0  # a repeated token
    ids, keep = jax_decode(jnp.asarray(logits))
    tids, tkeep = ctc_greedy_decode(torch.from_numpy(logits))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(keep))
    for b in range(3):
        assert ctc_ids_to_text(tids[b], tkeep[b]) == jax_ids_to_text(
            np.asarray(ids[b]), np.asarray(keep[b]))


def test_wer_matches_reference():
    pairs = [("the cat sat", "the cat sat"), ("the cat sat on", "a cat on mat"),
             ("one", ""), ("a b c d", "a x c d e")]
    for ref, hyp in pairs:
        assert wer(ref, hyp) == jax_wer(ref, hyp)
