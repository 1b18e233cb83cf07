"""The port's mel front end, Griffin-Lim and attribution post-processing
against the reference package on the same numpy-seeded inputs. Each
reference function is jitted once per case (one program, not one compile
per eager op)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_shap.audio import invert as jax_invert
from asr_shap.audio import mel as jax_mel
from asr_shap.postprocess import attribution as jax_post
from asr_shap_torch.audio import invert, mel
from asr_shap_torch.postprocess import attribution as post

SR = 16_000


@pytest.fixture(scope="module")
def clip():
    """A voiced 0.4 s clip with a silent gap and light noise."""
    rng = np.random.default_rng(21)
    t = np.arange(6400) / SR
    x = 0.5 * np.sin(2 * np.pi * 180 * t) + 0.2 * np.sin(2 * np.pi * 1230 * t)
    x[2500:3500] = 0.0
    return (x + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------------------------------------------- mel

@pytest.mark.parametrize("scale", ["slaney", "htk"])
@pytest.mark.parametrize("norm", ["slaney", None])
def test_mel_filterbank_equals_reference(scale, norm):
    """The same numpy arithmetic: equal bit for bit."""
    got = mel.mel_filterbank(SR, 512, 40, 20.0, 7000.0, scale, norm)
    want = jax_mel.mel_filterbank(SR, 512, 40, 20.0, 7000.0, scale, norm)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("power,window", [(2.0, "hann"), (1.0, "hann"), (2.0, "ones"),
                                          (1.0, "ones")])
def test_stft_magnitude_matches_reference(clip, power, window):
    """float32 rFFTs of 512-sample frames, another FFT: 1e-5 of max|.|."""
    kw = dict(n_fft=512, hop_length=160, window=window, power=power)
    want = jax.jit(functools.partial(jax_mel.stft_magnitude, **kw))(jnp.asarray(clip))
    got = mel.stft_magnitude(_t(clip), **kw)
    assert got.shape == want.shape == (1 + 6400 // 160, 257)
    _close(got, want, 0, 1e-5 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("log,top_db", [("db", 80.0), ("db", None), ("natural", 80.0),
                                        ("none", 80.0)])
def test_log_mel_spectrogram_matches_reference(clip, log, top_db):
    """A batch of two clips (the dB reference is per clip). "db": 1e-3 dB
    absolute; "natural": 1e-3 absolute on the log (relative 1e-3 on the
    power); "none": 1e-5 of max|mel|."""
    batch = np.stack([clip, 0.1 * clip[::-1]])
    kw = dict(sr=SR, n_fft=512, hop_length=160, n_mels=40, scale="htk", norm=None,
              log=log, top_db=top_db)
    want = jax.jit(functools.partial(jax_mel.log_mel_spectrogram, **kw))(jnp.asarray(batch))
    got = mel.log_mel_spectrogram(_t(batch), **kw)
    assert got.shape == want.shape == (2, 41, 40)
    atol = 1e-5 * float(jnp.abs(want).max()) if log == "none" else 1e-3
    _close(got, want, 0, atol)


def test_unknown_window_raises(clip):
    with pytest.raises(ValueError, match="unknown window"):
        mel.stft_magnitude(_t(clip), window="hamming")


# ---------------------------------------------------------------- invert

def test_istft_rebuilds_the_signal(clip):
    """istft of the centred STFT gives the clip back (Hann overlap-add at
    hop n_fft/4), and equals the reference's istft of the same spectrum."""
    spec = invert._stft_complex(_t(clip), 512, 128)
    got = invert.istft(spec, 512, 128, 6400)
    _close(got, clip, 0, 1e-5)
    want = jax.jit(jax_invert.istft, static_argnums=(1, 2, 3))(
        jnp.asarray(spec.numpy()), 512, 128, 6400)
    _close(got, want, 0, 1e-6)


@pytest.mark.parametrize("kind", ["griffin_lim", "mel_to_audio"])
def test_griffin_lim_matches_reference(clip, kind):
    """8 iterations from the zero phase, the same magnitude: relative L2 to
    the reference's output under 1e-3 (float32 FFTs in another order,
    through 8 phase normalisations)."""
    if kind == "griffin_lim":
        mag = mel.stft_magnitude(_t(clip), 512, 128, power=1.0)
        got = invert.griffin_lim(mag, 512, 128, n_iter=8)
        want = jax.jit(functools.partial(jax_invert.griffin_lim, n_fft=512, hop_length=128,
                                         n_iter=8))(jnp.asarray(mag.numpy()))
    else:
        power = mel.log_mel_spectrogram(_t(clip), n_fft=512, hop_length=128, n_mels=64,
                                        log="none")
        got = invert.mel_to_audio(power, n_fft=512, hop_length=128, length=6400, n_iter=8)
        want = jax.jit(functools.partial(jax_invert.mel_to_audio, n_fft=512, hop_length=128,
                                         length=6400, n_iter=8))(jnp.asarray(power.numpy()))
    want = np.asarray(want)
    assert got.shape == want.shape
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-3, rel


# ----------------------------------------------------------- postprocess

def _cases():
    rng = np.random.default_rng(5)
    audio = rng.standard_normal(1000).astype(np.float32)
    phi = rng.standard_normal((1000, 12)).astype(np.float32)
    tied = rng.uniform(0, 0.5, 400).astype(np.float32)
    tied[:20] = 3.0  # 5% at the max: the 98th percentile is the max
    quiet = (0.3 * rng.standard_normal(6000)).astype(np.float32)
    quiet[1500:4000] *= 0.01
    return {
        # name: (port fn, reference fn, args, static kwargs)
        "block_mean_smooth_partial_block": (
            post.block_mean_smooth, jax_post.block_mean_smooth, (phi.T,), {}),
        "block_mean_smooth_whole_blocks": (
            post.block_mean_smooth, jax_post.block_mean_smooth, (phi.T[:, :960],), {}),
        "normalize_and_scale": (
            post.normalize_and_scale, jax_post.normalize_and_scale, (phi,), {}),
        "normalize_and_scale_flat": (
            post.normalize_and_scale, jax_post.normalize_and_scale,
            (np.full(300, 0.25, np.float32),), dict(default=0.3)),
        "normalize_and_scale_threshold_at_max": (
            post.normalize_and_scale, jax_post.normalize_and_scale, (tied,), {}),
        "normalize_and_scale_percentile_100": (
            post.normalize_and_scale, jax_post.normalize_and_scale, (audio,),
            dict(percentile=100.0)),
        "character_masks": (
            post.character_masks, jax_post.character_masks, (audio, phi),
            dict(char_frames=(0, 3, 3, 11), sr=SR, block_ms=5.0)),
        "character_masks_empty": (
            post.character_masks, jax_post.character_masks, (audio, phi),
            dict(char_frames=())),
        # 7 frames: samples before the first centre (64) and past the last (832)
        "frame_to_sample_interp": (
            post.frame_to_sample_interp, jax_post.frame_to_sample_interp, (phi[:7, 0],),
            dict(n_samples=1000, hop_length=128, n_fft=128)),
        "repeat_upsample": (
            post.repeat_upsample, jax_post.repeat_upsample, (phi[:5],), dict(factor=3)),
        "shap_amplify": (post.shap_amplify, jax_post.shap_amplify, (audio, phi), {}),
        "shap_amplify_flat": (
            post.shap_amplify, jax_post.shap_amplify, (audio, np.ones((1000, 3), np.float32)),
            dict(factor=1.5)),
        "rms_frames": (post.rms_frames, jax_post.rms_frames, (quiet,), {}),
        "amplify_quiet_sections": (
            post.amplify_quiet_sections, jax_post.amplify_quiet_sections, (quiet,),
            dict(energy_threshold=0.05, amplification_factor=3.0)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_postprocess_matches_reference(name):
    """Each function against the reference's, jitted, on the same inputs:
    1e-6 absolute (float32 means and divisions in another order), masks
    within 1e-5 (a percentile of min-max normalized values)."""
    fn, ref_fn, args, kw = CASES[name]
    want = jax.jit(functools.partial(ref_fn, **kw))(*map(jnp.asarray, args))
    got = fn(*map(_t, args), **kw)
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, 1e-5, 1e-5, name)
    if name == "normalize_and_scale_threshold_at_max":
        assert set(np.unique(got[0].numpy())) == {0.0, 1.0}  # the binary mask
    if name == "normalize_and_scale_flat":
        assert bool((got[0] == 0.3).all())
    if name == "shap_amplify_flat":
        _close(got[0], 2.5 * args[0], 0, 0)  # norm = 1 everywhere


def test_char_group_frames_and_mismatch():
    """C C _ A | T T -> groups C@0 A@3 T@5; a count that disagrees with the
    transcription raises, as in the reference."""
    ids = np.array([19, 19, 0, 7, 4, 6, 6])
    assert post.char_group_frames(ids, "CA T") == jax_post.char_group_frames(ids, "CA T") \
        == [0, 3, 5]
    for package in (post, jax_post):
        with pytest.raises(ValueError, match="mismatch"):
            package.char_group_frames(np.array([7, 0, 24]), "ABC")


def test_percentile_has_no_size_limit_and_matches_quantile():
    """``percentile_last`` agrees with ``torch.quantile``'s "linear" rule
    where that runs, and runs on a row past its 2^24-element limit."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 5001)).astype(np.float32))
    for q in (0.0, 37.5, 98.0, 100.0):
        want = torch.quantile(x, q / 100, dim=-1, keepdim=True, interpolation="linear")
        _close(post.percentile_last(x, q), want, 1e-6, 1e-6, f"q={q}")
    big = torch.ones(2**24 + 8)
    big[-1] = 2.0
    with pytest.raises(RuntimeError):
        torch.quantile(big, 0.5)
    assert float(post.percentile_last(big, 50.0)) == 1.0
    assert float(post.percentile_last(big, 100.0)) == 2.0
