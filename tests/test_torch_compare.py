"""The port's LIME-vs-SHAP comparison, its figures and viewer, and the
``compare`` and ``visualize`` commands, against the reference package on
the same params, background, draws and LIME masks; the drawing commands
with and without matplotlib."""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.core.config import Wav2Vec2ConformerConfig as JaxConformerConfig
from asr_shap.core.prng import fold
from asr_shap.explain.baselines import zeros_noise_background as jax_background
from asr_shap.models.w2v2_conformer import w2v2_conformer_logits as jax_conformer_logits
from asr_shap.pipeline.compare import lime_shap_comparison as jax_comparison
from asr_shap.postprocess.attribution import shap_amplify as jax_shap_amplify
from asr_shap.viz.interactive import load_attribution_view as jax_view
from asr_shap_torch import cli
from asr_shap_torch.core import config as pc
from asr_shap_torch.pipeline import benchmarks, compare
from asr_shap_torch.viz import activations, interactive, static
from asr_shap_torch.viz.scrubber import SpectrogramScrubber
from asr_shap_torch.viz.wav_io import read_wav
from torch_port_configs import (
    conformer_params,
    jax_draws,
    jax_lime_masks,
    port_cfg,
    shared_params,
)

# the scalar record of asr_shap/pipeline/compare.py::lime_shap_comparison,
# and the keys its artifacts add
RECORD_KEYS = {"clip_samples", "pearson_r", "pearson_r_segments", "shap_wall_s",
               "lime_wall_s", "lime_num_samples", "shap_nsamples"}
ARTIFACT_KEYS = {"figure", "shap_wav", "lime_wav", "stats"}
TINY = ["--device", "cpu", "--tiny", "--random-init"]


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _tiny_conformer():
    return JaxConformerConfig(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=128, conv_dim=(32, 32), conv_stride=(5, 2),
                              conv_kernel=(10, 3), feat_proj_dim=32,
                              conv_depthwise_kernel_size=7)


@pytest.mark.parametrize("family", ["wav2vec2", "w2v2-conformer"])
def test_comparison_matches_reference(tmp_path, tiny_config, family):
    """One 800-sample clip through both packages' comparison, the port fed
    the reference's background (fold(key, 0)), expected-gradients draws
    (fold(key, 1)) and LIME masks (fold(key, 2)): shap_matrix and
    lime_per_sample within 2e-3 of max|.| (float32 forwards and backwards of
    a 2-layer model in another order), both r's within 1e-3, the same stats
    keys. The Wav2Vec2 case writes its artifacts in both packages: the same
    files, and the port's amplified wavs equal the reference's amplification
    of the port's own attributions within 1e-5 plus one 16-bit step."""
    key = jax.random.key(3)
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=2, num_background=2, remat=False,
                            lime_num_samples=16, lime_num_segments=8)
    audio = np.random.default_rng(8).standard_normal(2000).astype(np.float32)
    if family == "wav2vec2":
        cfg, logits_fn = tiny_config, None
        params, ref_params = shared_params(cfg, seed=5)
    else:
        cfg, logits_fn = _tiny_conformer(), jax_conformer_logits
        params, ref_params = conformer_params(cfg, seed=5)
    out = {name: (str(tmp_path / name) if family == "wav2vec2" else None)
           for name in ("ref", "port")}
    want = jax_comparison(ref_params, cfg, ec, audio, key=key, clip_seconds=0.05,
                          out_dir=out["ref"], logits_fn=logits_fn)
    n = 800
    got = compare.lime_shap_comparison(
        params, port_cfg(cfg), pc.ExplainerConfig(**dataclasses.asdict(ec)), audio,
        clip_seconds=0.05, out_dir=out["port"],
        background=torch.from_numpy(np.asarray(jax_background(fold(key, 0), n, 2, 0.01))),
        draws=jax_draws(fold(key, 1), 2, 2),
        masks=jax_lime_masks(fold(key, 2), 16, 8))
    assert got["shap_matrix"].shape == want["shap_matrix"].shape == (
        n, cfg.frames_for_samples(n))
    for field in ("shap_matrix", "lime_per_sample", "shap_per_sample"):
        scale = np.abs(want[field]).max()
        np.testing.assert_allclose(got[field], want[field], rtol=0, atol=2e-3 * scale,
                                   err_msg=field)
    for field in ("pearson_r", "pearson_r_segments"):
        assert got[field] == pytest.approx(want[field], abs=1e-3), field
    assert set(json.loads(compare.comparison_record(got))) == set(
        json.loads(compare.comparison_record(want))) == RECORD_KEYS | (
        ARTIFACT_KEYS if out["port"] else set())
    if not out["port"]:
        return
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["ref"]))
    with open(got["stats"]) as fh:
        assert set(json.loads(fh.read())) == RECORD_KEYS | ARTIFACT_KEYS - {"stats"}
    clip = jnp.asarray(compare.center_window(audio, n))
    amp = [np.asarray(jax_shap_amplify(clip, jnp.asarray(phi), 2.0))
           for phi in (got["shap_matrix"], got["lime_per_sample"][:, None])]
    peak = max(np.abs(amp[0]).max(), np.abs(amp[1]).max(), 1.0)
    for path, ref_amp in zip((got["shap_wav"], got["lime_wav"]), amp):
        samples, sr = read_wav(path)
        assert sr == 16_000 and samples.shape == (n,)
        np.testing.assert_allclose(samples, np.clip(ref_amp / peak, -1, 1), rtol=0,
                                   atol=1e-5 + 1 / 32767)
    port_amp = compare.amplified_pair(torch.from_numpy(np.asarray(clip)),
                                      torch.from_numpy(got["shap_matrix"]),
                                      torch.from_numpy(got["lime_per_sample"][:, None]))
    for a, b in zip(port_amp, amp):
        np.testing.assert_allclose(a, b / peak, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny_view(tmp_path_factory):
    """A tiny Wav2Vec2 (the conftest's config) whose lm_head never picks
    <s>, </s> or <unk> (their text is one group but several characters, so
    the reference's alignment would refuse the transcript), a 3,200-sample
    clip and a random phi: the inputs of both packages' attribution view."""
    from asr_shap.core.config import Wav2Vec2Config
    from asr_shap_torch.core.params_io import params_to_jax

    cfg = Wav2Vec2Config(vocab_size=32, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=128, conv_dim=(32, 32),
                         conv_stride=(5, 2), conv_kernel=(10, 3), conv_bias=False,
                         feat_extract_norm="group", num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4, feat_proj_dim=32)
    params, _ = shared_params(cfg, seed=9)
    params["lm_head"]["bias"][1:4] = -1e3
    ref_params = jax.tree.map(jnp.asarray, params_to_jax(params))
    rng = np.random.default_rng(4)
    audio = (0.3 * rng.standard_normal(3200)).astype(np.float32)
    phi = rng.standard_normal((3200, cfg.frames_for_samples(3200))).astype(np.float32)
    return cfg, params, ref_params, audio, phi


def test_attribution_view_matches_reference(tiny_view, tmp_path):
    """load_attribution_view against the reference's: transcription,
    display tokens and character frames equal, masks and masked audios
    within 1e-5 (the same percentile rule on float32 means); a [T, N] phi
    is transposed as in the reference; the viewer saves its figure,
    selects a character and exports that character's masked audio; a
    conformer config raises ValueError."""
    cfg, params, ref_params, audio, phi = tiny_view
    want = jax_view(ref_params, cfg, audio, phi)
    got = interactive.load_attribution_view(params, port_cfg(cfg), audio, phi.T)
    assert got.transcription == want.transcription and got.transcription
    assert got.display_tokens == want.display_tokens
    assert got.char_frames == want.char_frames
    for field in ("masks", "masked_audios"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=0,
                                   atol=1e-5, err_msg=field)
    viewer = interactive.AttributionViewer(got)
    viewer.savefig(str(tmp_path / "view.png"))
    assert (tmp_path / "view.png").stat().st_size > 0
    last = len(got.char_frames) - 1
    viewer.select(last)
    path = viewer.export_selected(str(tmp_path / "char.wav"))
    samples, _ = read_wav(path)
    np.testing.assert_allclose(samples, np.clip(got.masked_audios[last], -1, 1), atol=1 / 32767)
    with pytest.raises(ValueError, match="Wav2Vec2"):
        interactive.load_attribution_view(params, port_cfg(_tiny_conformer()), audio, phi)


FIGURES = {
    "spectrogram_overlay": lambda a, p, path: static.plot_shap_spectrogram_overlay(
        a, p, n_fft=256, hop_length=64, n_mels=32, out_path=path),
    "waveform_attribution": lambda a, p, path: static.plot_waveform_attribution(
        a, p, amplified=2 * a, out_path=path),
    "eta_wer_scatter": lambda a, p, path: static.plot_eta_wer_scatter(
        [{"snr": s, "wer": w, "eta_raw": e, "type": "noisy"}
         for s, w, e in ((5.0, 0.5, 0.2), (5.0, 0.7, 0.3), (1.0, 0.9, 0.1))], out_path=path),
    "faithfulness_curves": lambda a, p, path: static.plot_faithfulness_curves(
        {"grad": [{"mode": "deletion", "base_wer": 0.1,
                   "points": [{"fraction": 0.1, "wer_topk": 0.5, "wer_random": 0.2}]}]},
        out_path=path),
    "activation_curves": lambda a, p, path: activations.plot_activation_curves(path),
    "rescale_multipliers": lambda a, p, path: activations.plot_rescale_multipliers(path),
    "glu_graph": lambda a, p, path: activations.plot_glu_graph(path),
}


@pytest.mark.parametrize("name", list(FIGURES))
def test_figures_write_pngs(tmp_path, name):
    rng = np.random.default_rng(1)
    audio = (0.3 * rng.standard_normal(4000)).astype(np.float32)
    path = str(tmp_path / f"{name}.png")
    FIGURES[name](audio, rng.standard_normal(4000), path)
    assert os.path.getsize(path) > 0


def test_scrubber_exports_griffin_lim_of_its_window(tmp_path):
    """The scrubber's window around a frame is mel_to_audio of its mel
    power's frames (16 iterations), written as a wav."""
    from asr_shap_torch.audio.invert import mel_to_audio

    audio = np.sin(2 * np.pi * 300 * np.arange(8000) / 16_000).astype(np.float32)
    scr = SpectrogramScrubber(audio, n_fft=256, hop_length=64, n_mels=32, device="cpu")
    frame = scr.frame_audio(10)
    want = mel_to_audio(scr.mel_power[6:15], 16_000, 256, 64, 64 * 8 + 128, n_iter=16)
    np.testing.assert_array_equal(frame, want.numpy())
    path = scr.export_frame(10, str(tmp_path / "f.wav"))
    assert read_wav(path)[0].shape == frame.shape


@pytest.fixture(scope="module")
def cli_store(tmp_path_factory):
    """A store written by the port's run-shap on the tiny preset."""
    d = str(tmp_path_factory.mktemp("store") / "data")
    cli.main(["run-shap", *TINY, "--data-dir", d, "--num-samples", "1", "--snrs", "5",
              "--min-length", "1600", "--max-length", "1600", "--nsamples", "2"])
    return d


@pytest.mark.parametrize("command", ["sweep", "faithfulness", "bench", "visualize"])
def test_drawing_commands_write_figures(cli_store, tmp_path, capsys, command):
    """sweep, faithfulness and bench with --plot write the figure and print
    the same JSON lines as without it (bench: the same rows but their
    times); visualize --save writes the viewer of the store's first
    sample."""
    png = str(tmp_path / "fig.png")
    if command == "visualize":
        cli.main(["visualize", *TINY, "--data-dir", cli_store, "--save", png])
        assert os.path.getsize(png) > 0
        return
    if command == "bench":
        argv = ["bench", "--device", "cpu", "--tiny", "--lengths", "800", "--nsamples", "1"]
    else:
        argv = [command, *TINY, "--data-dir", cli_store]
    rows = {}
    for plot in ([], ["--plot", png]):
        extra = ["--json", str(tmp_path / f"rows{len(plot)}.json")] if command == "bench" else []
        cli.main(argv + plot + extra)
        rows[len(plot)] = (json.loads((tmp_path / f"rows{len(plot)}.json").read_text())
                           if command == "bench" else _json_lines(capsys))
    assert os.path.getsize(png) > 0
    if command == "bench":
        drop = {"wall_s", "compile_s", "passes_per_s"}
        rows = {k: [{f: r[f] for f in r if f not in drop} for r in v] for k, v in rows.items()}
    assert rows[0] == rows[2] and rows[0]


def test_compare_cli_prints_reference_keys(tmp_path, capsys):
    """compare on the tiny preset: the reference CLI's record, and the
    artifact set under --out-dir; --out-dir '' prints the record alone.
    0.1 s clips, as the reference's own CLI test: the tiny preset keeps
    every tenth sample as a frame, so a 2 s clip has 3,199 output rows."""
    argv = ["compare", *TINY, "--clip-seconds", "0.1", "--nsamples", "2",
            "--lime-samples", "16"]
    out = tmp_path / "artifacts"
    cli.main(argv + ["--out-dir", str(out)])
    (rec,) = _json_lines(capsys)
    assert set(rec) == RECORD_KEYS | ARTIFACT_KEYS
    assert rec["lime_num_samples"] == 16 and rec["shap_nsamples"] == 2
    assert sorted(os.listdir(out)) == sorted(
        os.path.basename(rec[k]) for k in ARTIFACT_KEYS)
    cli.main(argv + ["--out-dir", ""])
    (bare,) = _json_lines(capsys)
    assert set(bare) == RECORD_KEYS
    assert {k: bare[k] for k in ("pearson_r", "pearson_r_segments", "clip_samples")} == \
        {k: rec[k] for k in ("pearson_r", "pearson_r_segments", "clip_samples")}


@pytest.mark.parametrize("argv", [
    ["sweep", *TINY, "--plot", "scatter.png"],
    ["faithfulness", *TINY, "--plot", "curves.png"],
    ["bench", "--device", "cpu", "--tiny", "--plot", "runtime.png"],
    ["compare", *TINY, "--out-dir", "OUT"],
    ["visualize", *TINY, "--save", "view.png"],
    ["visualize", *TINY],
], ids=["sweep", "faithfulness", "bench", "compare", "visualize-save", "visualize"])
def test_drawing_commands_refuse_without_matplotlib(tmp_path, monkeypatch, argv):
    """Where matplotlib does not import, a command asked to draw raises
    ImportError naming its flag before any work: no model is loaded, no
    store read, no file written."""
    def no_work(*args, **kw):
        raise AssertionError("work began before the refusal")

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(cli, "_load_model", no_work)
    monkeypatch.setattr(benchmarks, "resolve_device", no_work)
    monkeypatch.setattr(compare, "params_device", no_work)
    monkeypatch.chdir(tmp_path)
    argv = [str(tmp_path / "OUT") if a == "OUT" else a for a in argv]
    if argv[0] in ("sweep", "faithfulness", "visualize"):
        argv += ["--data-dir", str(tmp_path / "data")]
    with pytest.raises(ImportError, match="matplotlib"):
        cli.main(argv)
    if argv[0] == "compare":
        with pytest.raises(ImportError, match="out_dir"):
            compare.lime_shap_comparison(None, None, pc.ExplainerConfig(), np.zeros(10),
                                         out_dir=str(tmp_path / "OUT"))
    assert os.listdir(tmp_path) == []
