"""The port's controlled test set against the reference package on the CPU:
the text-conditional synthesis under a shared numpy Generator, the
resampler, the noise generators and create_test_set on supplied sources.
The port's random streams are not JAX's, so its noise draws are checked by
the SNR they reach and its spectrum shaping on the reference's white draw."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.audio.noise import colored_noise as jax_colored_noise
from asr_shap.audio.noise import mix_at_snr as jax_mix_at_snr
from asr_shap.audio.resample import resample as jax_resample
from asr_shap.core.config import TestSetConfig as JaxTestSetConfig
from asr_shap.pipeline import testset as jax_testset
from asr_shap_torch.audio.noise import (
    add_white_noise_at_snr,
    mix_at_snr,
    shape_spectrum,
)
from asr_shap_torch.audio.resample import resample, resampled_length
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.prng import generator
from asr_shap_torch.pipeline import testset


def test_text_synthesis_bit_for_bit():
    ref_rng, rng = np.random.default_rng(11), np.random.default_rng(11)
    text = testset.synthetic_text(rng, 7)
    assert text == jax_testset.synthetic_text(ref_rng, 7)
    np.testing.assert_array_equal(testset.synthesize_text(rng, text + " DON'T"),
                                  jax_testset.synthesize_text(ref_rng, text + " DON'T"))


@pytest.mark.parametrize("orig,new,n", [(8_000, 16_000, 8_000), (44_100, 16_000, 44_100),
                                        (8_000, 16_000, 7_999)])
def test_resample_matches_reference(rng, orig, new, n):
    x = rng.standard_normal(n).astype(np.float32)
    got = resample(torch.from_numpy(x), orig, new).numpy()
    want = np.asarray(jax.jit(jax_resample, static_argnums=(1, 2))(jnp.asarray(x), orig, new))
    assert got.shape == want.shape == (resampled_length(n, orig, new),)
    # float32 sums over the FIR taps (up to 475 at 44.1 kHz), another order
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_noise_generators(rng):
    # the spectrum shaping on the reference's own white draw
    key = jax.random.key(3)
    white = np.array(jax.random.normal(key, (16_001,), jnp.float32))
    np.testing.assert_allclose(shape_spectrum(torch.from_numpy(white), 1.0).numpy(),
                               np.asarray(jax.jit(jax_colored_noise, static_argnums=(1, 2))(
                                   key, 16_001, 1.0)),
                               atol=1e-5, rtol=0)  # unit variance, float32 FFTs
    # white noise reaches its SNR: at 16,000 samples the sample power spreads
    # by about sqrt(2 / N), some 0.05 dB
    audio = torch.from_numpy((0.4 * np.sin(np.arange(16_000) / 7.0)).astype(np.float32))
    for j, snr in enumerate((5.0, 2.0, 1.0, -5.0)):
        noisy, noise = add_white_noise_at_snr(generator(0, 0, j), audio, snr)
        reached = 10 * np.log10(float(audio.square().mean()) / float(noise.square().mean()))
        assert abs(reached - snr) < 0.25
        torch.testing.assert_close(noisy - noise, audio, atol=1e-6, rtol=0)
    speech = rng.standard_normal(3000).astype(np.float32)
    short = rng.standard_normal(1100).astype(np.float32)
    np.testing.assert_allclose(
        mix_at_snr(torch.from_numpy(speech), torch.from_numpy(short), 2.0).numpy(),
        np.asarray(jax_mix_at_snr(jnp.asarray(speech), jnp.asarray(short), 2.0)),
        atol=1e-6, rtol=0)


def test_create_test_set_on_supplied_sources(rng):
    clip_a = (0.3 * rng.standard_normal(20_000)).astype(np.float32)
    clip_b = (0.3 * rng.standard_normal(24_000)).astype(np.float32)
    clip_8k = (0.3 * rng.standard_normal(9_000)).astype(np.float32)
    kw = dict(num_samples=3, snrs_db=(5.0, 1.0), min_length=16_000, max_length=20_000)
    sources = [(clip_a, "HELLO"), (clip_a[:100], "SHORT"), (clip_b, "WORLD"),
               (clip_8k, "EIGHT KHZ", 8_000)]
    want = jax_testset.create_test_set(JaxTestSetConfig(**kw), iter(sources))
    got = testset.create_test_set(pc.TestSetConfig(**kw), iter(sources))
    assert [(s["type"], s["snr"], s["text"], len(s["audio"]), len(s["noise"])) for s in got] \
        == [(s["type"], s["snr"], s["text"], len(s["audio"]), len(s["noise"])) for s in want]
    assert len(got) == 9 and len(got[6]["audio"]) == 18_000
    for g, w in zip(got, want):
        if g["type"] == "clean":
            # the resampled 8 kHz clip within float32 sums of the reference's
            np.testing.assert_allclose(g["audio"], w["audio"], atol=1e-5, rtol=0)
            assert not g["noise"].any()
            clean = g["audio"]
        else:
            # mixed - noise is the clean clip to the rounding of the sum
            np.testing.assert_allclose(g["audio"] - g["noise"], clean, atol=1e-6, rtol=0)


def test_synthetic_provider_is_seeded():
    cfg = pc.TestSetConfig(num_samples=2, snrs_db=(5.0,), min_length=16_000, seed=3)
    a, b = testset.create_test_set(cfg), testset.create_test_set(cfg)
    assert [s["type"] for s in a] == ["clean", "noisy"] * 2
    assert len(a[0]["audio"]) >= 16_000 and len(a[2]["audio"]) >= 24_000
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["audio"], y["audio"])
        assert x["text"] == y["text"]
    # the clip is the synthesis of its text (then zero-padded to length)
    audio, text = testset.synthetic_utterance(np.random.default_rng(
        np.random.SeedSequence([3, 1000])), 16_000)
    assert text == a[0]["text"]
    np.testing.assert_array_equal(audio, a[0]["audio"])
