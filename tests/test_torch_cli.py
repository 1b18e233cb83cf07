"""``python -m asr_shap_torch`` on the CPU against the reference CLI, the
params archive both ways between the packages, and the run-shap options
that the port's pipeline once ignored (``--kmeans``, ``--host-draw-chunk``)
against the reference's pipeline step."""

import dataclasses
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.cli import main as jax_cli
from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.core.config import PipelineConfig as JaxPipelineConfig
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.core.params_io import save_params as jax_save_params
from asr_shap.core.prng import fold
from asr_shap.explain.baselines import kmeans_background as jax_kmeans
from asr_shap.explain.baselines import zeros_noise_background as jax_background
from asr_shap.pipeline.run_shap import _host_chunked_step
from asr_shap.pipeline.sweep import sweep_summary as jax_sweep_summary
from asr_shap_torch.cli import main as cli
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import load_config, load_params, params_to_jax, save_params
from asr_shap_torch.explain.baselines import kmeans_background
from asr_shap_torch.explain.expected_gradients import num_draws
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params
from asr_shap_torch.pipeline.run_shap import chunked_phi, draw_chunks
from asr_shap_torch.viz.wav_io import write_wav
from torch_port_configs import jax_draws, port_cfg, shared_params


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_cli_commands_match_reference_cli(tmp_path, capsys, tiny_config):
    """run-shap -> sweep -> metric -> transcribe through the port's CLI on
    an archive the reference wrote: each line's keys against the reference
    CLI's, transcribe's values against the reference CLI's on the same
    file, and metric and transcribe against the sweep (whose records are
    held to the reference's in test_torch_sweep.py)."""
    params, _ = shared_params(tiny_config, seed=2)
    port_archive, ref_archive = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_params(port_archive, params, port_cfg(tiny_config))
    jax_save_params(ref_archive, jax_load_params(port_archive), jax_load_config(port_archive))
    d = str(tmp_path / "data")
    model = ["--params", ref_archive]

    cli(["run-shap", "--device", "cpu", *model, "--data-dir", d, "--num-samples", "1",
         "--snrs", "5", "--min-length", "800", "--max-length", "800", "--nsamples", "2",
         "--draw-chunk", "1", "--host-draw-chunk", "1", "--kmeans", "3",
         "--output-chunk", "0"])
    (run,) = _json_lines(capsys)
    assert set(run) == {"computed", "total_wall_s", "data_dir"}  # asr_shap/cli.py
    assert run["computed"] == 2
    phi = np.load(os.path.join(d, "shap_values_sample_1_noisy_5.npy"))
    assert phi.shape == (800, tiny_config.frames_for_samples(800))
    assert np.isfinite(phi).all() and np.abs(phi).max() > 0

    cli(["sweep", *model, "--device", "cpu", "--data-dir", d, "--plot", ""])
    *records, summary = _json_lines(capsys)
    # the reference's record keys (asr_shap/pipeline/sweep.py), and its
    # summary line, computed by its own sweep_summary from these records
    assert [set(r) for r in records] == [{"index", "type", "snr", "wer", "eta_raw",
                                          "reference", "hypothesis"}] * 2
    ref_summary = jax_sweep_summary(records)
    assert summary == json.loads(json.dumps(
        {"pearson_r": ref_summary["pearson_r_noisy"], "n": 2, **ref_summary}))

    stored = [os.path.join(d, f"{kind}_sample_1_noisy_5.npy")
              for kind in ("audio", "noise", "shap_values")]
    cli(["metric", "--audio", stored[0], "--noise", stored[1], "--shap", stored[2],
         "--itm", "strict", "--device", "cpu"])
    (metric,) = _json_lines(capsys)
    assert set(metric) == {"eta_raw", "segment_ms", "percentile", "itm"}  # asr_shap/cli.py
    assert metric["eta_raw"] == records[1]["eta_raw"]  # the sweep's noisy row

    clip = os.path.join(d, "audio_sample_0_clean_inf.npy")
    wav = str(tmp_path / "clip_8k.wav")
    write_wav(wav, np.load(stored[0])[:600] * 0.5, sr=8_000)
    cli(["transcribe", "--device", "cpu", *model, clip, wav])
    got, got_wav = _json_lines(capsys)
    jax_cli(["transcribe", *model, clip])
    (want,) = _json_lines(capsys)
    assert got["transcript"] == records[0]["hypothesis"]  # the sweep's clean row
    assert set(got) == set(want) == set(got_wav)
    assert {k: got[k] for k in got if k != "confidence"} == \
        {k: want[k] for k in want if k != "confidence"}
    assert got["confidence"] == pytest.approx(want["confidence"], abs=1e-5)
    assert got_wav["samples"] == 1200  # 600 samples at 8 kHz, resampled to 16 kHz


@pytest.mark.parametrize("argv,error", [
    (["run-shap", "--device", "cpu", "--hf", "facebook/wav2vec2-base-960h"], ImportError),
    (["faithfulness", "--device", "cpu", "--plot", "f.png"], ImportError),
    (["sweep", "--device", "cpu", "--plot", "scatter.png"], ImportError),
    (["sweep", "--device", "cpu", "--arch", "w2v2-conformer", "--params",
      "artifacts/params_synthetic_study.npz"], ValueError),
    (["transcribe", "--tiny", "--random-init", "clip.npy"], RuntimeError),
])
def test_cli_refuses_before_any_work(tmp_path, monkeypatch, argv, error):
    """Unported options raise before any work, and so do --plot where
    matplotlib does not import and --hf where transformers does not (the
    GPU machine has neither); without --device the CLI asks for CUDA and
    raises where there is none, never falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(error):
        cli(argv + ["--data-dir", str(tmp_path / "data")] if argv[0] != "transcribe"
            else argv)
    assert not (tmp_path / "data").exists()


def test_mesh_without_torchrun_runs_unsharded(tmp_path, capsys, monkeypatch):
    """--mesh in a world of one process (no torchrun environment) runs
    unsharded, as the reference's --mesh does on one device (queue 1, item
    8 ported the mesh): the same store as a run without it, and no process
    group."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    args = ["run-shap", "--device", "cpu", "--tiny", "--random-init", "--num-samples", "1",
            "--snrs", "5", "--min-length", "800", "--max-length", "800", "--nsamples", "2",
            "--sample-batch", "2"]
    stores = {}
    for name, extra in (("mesh", ["--mesh", "--async-writes"]), ("plain", [])):
        d = tmp_path / name
        cli(args + ["--data-dir", str(d)] + extra)
        (line,) = _json_lines(capsys)
        assert line["computed"] == 2
        stores[name] = {p.name: p.read_bytes() for p in d.glob("*.npy")}
    assert not torch.distributed.is_initialized()
    assert len(stores["mesh"]) == 8 and stores["mesh"] == stores["plain"]


@pytest.mark.parametrize("family", ["wav2vec2", "w2v2-conformer"])
def test_params_archive_loads_in_both_packages(tmp_path, tiny_config, family):
    if family == "wav2vec2":
        cfg = port_cfg(tiny_config)
        params, _ = shared_params(tiny_config, seed=4)
    else:
        cfg = pc.Wav2Vec2ConformerConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, conv_dim=(32, 32), conv_stride=(5, 2),
            conv_kernel=(10, 3), feat_proj_dim=32, conv_depthwise_kernel_size=7)
        params = init_w2v2_conformer_params(4, cfg, device="cpu")
    port_archive, ref_archive = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_params(port_archive, params, cfg)
    ref_tree = jax_load_params(port_archive)
    want = params_to_jax(params)
    assert jax.tree.structure(ref_tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref_cfg = jax_load_config(port_archive)
    assert type(ref_cfg).__name__ == type(cfg).__name__
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)

    jax_save_params(ref_archive, ref_tree, ref_cfg)
    assert load_config(ref_archive) == cfg
    back = load_params(ref_archive, device="cpu")
    for a, b in zip(jax.tree.leaves(params_to_jax(back)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_kmeans_background_matches_reference(rng):
    data = rng.standard_normal((7, 50)).astype(np.float32)
    data[:3] += 4.0  # two clear groups and a spread one
    key = jax.random.key(5)
    init = np.array(jax.random.choice(key, 7, (3,), replace=False))
    want = np.asarray(jax_kmeans(key, jnp.asarray(data), 3))
    got = kmeans_background(torch.from_numpy(data), 3, torch.from_numpy(init))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    same = torch.from_numpy(data[:2])
    assert kmeans_background(same, 2, torch.tensor([0, 1])) is same  # k >= M


def test_host_draw_chunk_and_kmeans_match_reference_step(rng, tiny_config):
    """nsamples=3, draw_chunk=1, host_draw_chunk=2: two chunks of two draws,
    each from the reference's key path fold(fold(key, 1), c), over a
    background of 5 rows reduced to 3 centroids; phi against the
    reference's host-chunked pipeline step."""
    ec = JaxExplainerConfig(nsamples=3, draw_chunk=1, host_draw_chunk=2, num_background=5,
                            kmeans_background=3, output_chunk=0, remat=False)
    params, ref_params = shared_params(tiny_config, seed=3)
    x = rng.standard_normal(800).astype(np.float32)
    x = (x - x.mean()) / np.sqrt(x.var() + 1e-7)
    key = fold(jax.random.key(0), 4)  # sample 4 of a run with seed 0
    want, _, _, _ = _host_chunked_step(JaxPipelineConfig(model=tiny_config, explainer=ec))(
        ref_params, jnp.asarray(x)[None], jnp.stack([key]))

    pec = pc.ExplainerConfig(**dataclasses.asdict(ec))
    chunks = draw_chunks(pec)
    assert [num_draws(c) for c in chunks] == [2, 2]
    bg = jax_background(fold(key, 0), 800, 5, 0.01)
    init = jax.random.choice(fold(key, 2), 5, (3,), replace=False)
    bg = kmeans_background(torch.from_numpy(np.asarray(bg)), 3,
                           torch.from_numpy(np.asarray(init)))
    draws = [jax_draws(fold(fold(key, 1), c), 2, 3) for c in range(len(chunks))]
    f = make_explained_fn(params, port_cfg(tiny_config), pec)
    got = chunked_phi(f, torch.from_numpy(x), bg, chunks, draws).numpy()
    want = np.asarray(want[0])
    # float32 through a 2-layer model and its batched backward: 2e-3 of max|phi|
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max())

    big = pc.ExplainerConfig(nsamples=200, draw_chunk=8, host_draw_chunk=80)
    assert sum(num_draws(c) for c in draw_chunks(big)) == 240  # the reference's count
    assert sum(num_draws(c) for c in draw_chunks(dataclasses.replace(big, host_draw_chunk=0))) \
        == 200
