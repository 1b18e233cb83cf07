"""The port's eta_raw-vs-WER sweep against the reference package on the CPU:
records of the same store (a random tiny model, and the trained study
archive on the reference's own test set), the summary statistics of a
committed study, batch WER, and eta_raw's degenerate cases."""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import MetricConfig as JaxMetricConfig
from asr_shap.core.config import TestSetConfig as JaxTestSetConfig
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.core.store import AttributionStore as JaxStore
from asr_shap.core.store import key_for as jax_key_for
from asr_shap.metrics import eta_raw as jax_eta_raw
from asr_shap.metrics.wer import batch_wer as jax_batch_wer
from asr_shap.ops.ctc import ctc_decode_batch as jax_decode_batch
from asr_shap.ops.ctc import text_to_ids as jax_text_to_ids
from asr_shap.pipeline.sweep import eta_wer_sweep as jax_sweep
from asr_shap.pipeline.testset import _synthetic_provider as jax_provider
from asr_shap.pipeline.testset import create_test_set as jax_create_test_set
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import load_config, load_params
from asr_shap_torch.core.store import AttributionStore
from asr_shap_torch.metrics.eta_raw import eta_raw
from asr_shap_torch.metrics.wer import batch_wer
from asr_shap_torch.ops.ctc import ctc_decode_batch, text_to_ids
from asr_shap_torch.pipeline.sweep import eta_wer_sweep, sweep_summary
from torch_port_configs import port_cfg, shared_params

STUDY_ARCHIVE = "artifacts/params_synthetic_study.npz"
STUDY = "artifacts/study_r5_kernel"


def _store_samples(rng, d, samples, t_phi):
    """Write (index, type, snr, clean, noise, text) samples to a reference
    store under ``d``, with a random phi [N, t_phi] each."""
    store = JaxStore(d)
    for i, type_, snr, clean, noise, text in samples:
        phi = rng.standard_normal((len(clean), t_phi)).astype(np.float32)
        store.save(jax_key_for(i, type_, snr), clean + noise, noise, phi, text)


def _assert_same_records(got, want):
    assert [(r["index"], r["type"], r["snr"]) for r in got] == \
        [(r["index"], r["type"], r["snr"]) for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["hypothesis"] == w["hypothesis"]
        assert g["reference"] == w["reference"]
        assert g["wer"] == w["wer"] or (math.isnan(g["wer"]) and math.isnan(w["wer"]))
        assert g["eta_raw"] == pytest.approx(w["eta_raw"], abs=1e-6)


def test_sweep_matches_reference_two_buckets(rng, tmp_path, tiny_config):
    """Three clips of 1,600 samples (one bucket, split by batch=2) and one of
    2,000 (a second bucket)."""
    params, ref_params = shared_params(tiny_config, seed=1)
    samples = []
    for i, (n, type_, snr) in enumerate([(1600, "clean", float("inf")), (1600, "noisy", 5.0),
                                         (1600, "noisy", 2.0), (2000, "clean", float("inf"))]):
        t = np.arange(n) / 16_000
        clean = (0.3 * np.sin(2 * np.pi * 180 * t) * np.sin(2 * np.pi * 4 * t)
                 ).astype(np.float32)
        noise = (np.zeros(n) if type_ == "clean" else
                 rng.standard_normal(n) * 0.3 * 10 ** (-snr / 20)).astype(np.float32)
        samples.append((i, type_, snr, clean, noise, "HELLO WORLD"))
    d = str(tmp_path / "data")
    _store_samples(rng, d, samples, tiny_config.frames_for_samples(1600))
    want = jax_sweep(ref_params, tiny_config, JaxStore(d), JaxMetricConfig(), batch=2)
    got = eta_wer_sweep(params, port_cfg(tiny_config), AttributionStore(d),
                        pc.MetricConfig(), batch=2, device="cpu")
    assert len(got) == 4
    _assert_same_records(got, want)


def test_sweep_trained_archive_on_reference_test_set(rng, tmp_path):
    """The trained study archive on two clips of the reference's own test
    set (a clip and its 5 dB mix): real-word transcripts."""
    tcfg = JaxTestSetConfig(num_samples=1, snrs_db=(5.0,), min_length=16_000, seed=0)
    test_set = jax_create_test_set(tcfg, source=jax_provider(tcfg))
    d = str(tmp_path / "data")
    _store_samples(rng, d, [(i, s["type"], s["snr"], s["audio"] - s["noise"], s["noise"],
                             s["text"]) for i, s in enumerate(test_set)], 8)
    want = jax_sweep(jax_load_params(STUDY_ARCHIVE), jax_load_config(STUDY_ARCHIVE),
                     JaxStore(d), JaxMetricConfig())
    got = eta_wer_sweep(load_params(STUDY_ARCHIVE, device="cpu"), load_config(STUDY_ARCHIVE),
                        AttributionStore(d), pc.MetricConfig(), device="cpu")
    _assert_same_records(got, want)
    assert got[0]["hypothesis"] == test_set[0]["text"]  # the clean clip, word for word


def _assert_close_tree(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close_tree(g, w)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-12, rel=0)
    else:
        assert got == want


def test_sweep_summary_reproduces_committed_study():
    with open(f"{STUDY}/records.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(f"{STUDY}/summary.json") as f:
        want = json.load(f)
    # the CLI adds these two to the summary it prints
    for k in ("pearson_r", "n"):
        want.pop(k)
    _assert_close_tree(sweep_summary(records), want)


def test_batch_wer_matches_reference():
    refs = ["the cat sat", "the cat sat on", "one", "", "   ", "a b c d"]
    hyps = ["the cat sat", "a cat on mat", "", "x", "", "a x c d e"]
    got, want = batch_wer(refs, hyps), jax_batch_wer(refs, hyps)
    assert [math.isnan(w) for w in got] == [False, False, False, True, True, False]
    assert [w for w in got if not math.isnan(w)] == [w for w in want if not math.isnan(w)]
    assert [math.isnan(w) for w in want] == [math.isnan(w) for w in got]
    with pytest.raises(ValueError):
        batch_wer(["a"], [])


def test_ctc_decode_batch_and_text_to_ids_match_reference(rng):
    logits = rng.standard_normal((3, 30, 32)).astype(np.float32)
    logits[1, 20:, 9] += 9.0  # a run past row 1's length
    for lengths in (None, [30, 20, 7]):
        assert ctc_decode_batch(torch.from_numpy(logits), lengths) == \
            jax_decode_batch(jnp.asarray(logits), None if lengths is None
                             else np.asarray(lengths))
    for text in ("hello world", " Don't stop, 42 ", ""):
        assert text_to_ids(text) == jax_text_to_ids(text)


def test_eta_raw_degenerate_cases_on_device_and_under_vmap(rng):
    """No whole segment, or no relevant segment (phi nan), gives a float32 0
    on the input's device; a batch under torch.vmap equals the loop and the
    reference."""
    out = eta_raw(torch.empty(0, device="meta"), torch.empty(0, device="meta"),
                  torch.empty((0, 5), device="meta"))
    assert out.device.type == "meta" and out.dtype == torch.float32 and out.shape == ()

    clean = rng.standard_normal((3, 4000)).astype(np.float32)
    noise = (rng.standard_normal((3, 4000)) * 0.8).astype(np.float32)
    phi = rng.standard_normal((3, 4000, 6)).astype(np.float32)
    phi[1] = np.nan    # tau is nan: no segment is relevant
    phi[2] = 0.25      # one tie over every segment
    c, u, p = (torch.from_numpy(a) for a in (clean, noise, phi))
    looped = torch.stack([eta_raw(c[i], u[i], p[i]) for i in range(3)])
    mapped = torch.vmap(eta_raw)(c, u, p)
    torch.testing.assert_close(mapped, looped, rtol=0, atol=0)
    ref = jax.jit(jax_eta_raw)
    want = [float(ref(jnp.asarray(clean[i]), jnp.asarray(noise[i]), jnp.asarray(phi[i])))
            for i in range(3)]
    assert looped[1] == 0.0
    np.testing.assert_allclose(looped.numpy(), want, atol=1e-6, rtol=0)
