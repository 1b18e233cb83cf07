"""The port's deletion/insertion faithfulness score against the reference
package: the masked variants, the per-sample records and the summary on the
same audio, phi and transcripts, the batched transcription, and the
``faithfulness`` command over a store that ``run-shap --method kernel``
wrote."""

import json

import numpy as np
import pytest

from asr_shap.cli import main as jax_cli
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.core.params_io import save_params as jax_save_params
from asr_shap.metrics import faithfulness as jf
from asr_shap.models.wav2vec2 import wav2vec2_logits as jax_logits
from asr_shap_torch.cli import main as cli
from asr_shap_torch.core.params_io import save_params
from asr_shap_torch.metrics import faithfulness as pf
from torch_port_configs import port_cfg, shared_params


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _clip(rng, n=1200):
    audio = (0.1 * rng.standard_normal(n)).astype(np.float32)
    phi = rng.standard_normal((n, 7)).astype(np.float32)
    return audio, phi


@pytest.mark.parametrize("mode", ["deletion", "insertion"])
@pytest.mark.parametrize("fill", ["zero", "noise"])
def test_masked_variants_equal_reference(rng, mode, fill):
    audio, phi = _clip(rng)
    imp = pf.importance_per_sample(phi, audio.shape[0])
    np.testing.assert_array_equal(imp, jf.importance_per_sample(phi, audio.shape[0]))
    np.testing.assert_array_equal(pf.importance_per_sample(phi.T, audio.shape[0]), imp)
    got, meta = pf.masked_variants(audio, imp, (0.01, 0.1, 0.3), mode, fill, 2, seed=5)
    want, want_meta = jf.masked_variants(audio, imp, (0.01, 0.1, 0.3), mode, fill, 2, seed=5)
    assert got.shape == (1 + 3 * 3, audio.shape[0])
    np.testing.assert_array_equal(got, want)
    assert meta == want_meta


def test_curve_and_summary_equal_reference(rng):
    """The same audio, phi and transcripts (a transcript per variant from
    its energy, so masking moves it) give the reference's records and
    summary, for both modes."""
    words = ["THE", "QUICK", "BROWN", "FOX", "JUMPS"]

    def transcribe(batch):
        energy = np.sqrt((np.asarray(batch, np.float64) ** 2).mean(axis=1))
        return [" ".join(words[:max(1, int(5 * e / 0.1))]) for e in energy]

    records = {"port": [], "ref": []}
    for i, mode in enumerate(("deletion", "insertion", "deletion")):
        audio, phi = _clip(rng)
        for name, mod in (("port", pf), ("ref", jf)):
            records[name].append(mod.faithfulness_curve(
                transcribe, audio, phi, "THE QUICK BROWN FOX", fractions=(0.05, 0.2, 0.5),
                mode=mode, fill="noise" if i == 2 else "zero", n_random=2, seed=i))
    assert records["port"] == records["ref"]
    assert pf.faithfulness_summary(records["port"]) == jf.faithfulness_summary(records["ref"])
    assert pf.faithfulness_summary(records["port"][:1]) == \
        jf.faithfulness_summary(records["ref"][:1])


def test_transcribe_fn_matches_reference(rng, tiny_config):
    """One batched forward of 9 variants on the CPU gives the reference's
    transcripts."""
    params, ref_params = shared_params(tiny_config, seed=8)
    audio, phi = _clip(rng)
    imp = pf.importance_per_sample(phi, audio.shape[0])
    batch, _ = pf.masked_variants(audio, imp, (0.05, 0.2), "deletion", "noise", 3)
    got = pf.make_transcribe_fn(params, port_cfg(tiny_config))(batch)
    want = jf.make_transcribe_fn(ref_params, tiny_config, jax_logits)(batch)
    assert len(got) == 9 and got == want


def test_cli_faithfulness_over_a_kernel_store(tmp_path, capsys, tiny_config):
    """run-shap --method kernel writes the store; faithfulness --tiny
    --random-init scores it (records, summary, --out); the same store
    through the reference's CLI on the same weights gives the same lines."""
    d, out = str(tmp_path / "data"), str(tmp_path / "faith.jsonl")
    tiny = ["--device", "cpu", "--tiny", "--random-init"]
    cli(["run-shap", *tiny, "--data-dir", d, "--num-samples", "1", "--snrs", "5",
         "--min-length", "1600", "--max-length", "1600", "--nsamples", "8",
         "--kernel-segments", "4", "--method", "kernel"])
    (run,) = _json_lines(capsys)
    assert run["computed"] == 2
    argv = ["--data-dir", d, "--fractions", "0.05", "0.2", "--n-random", "2"]
    cli(["faithfulness", *tiny, *argv, "--out", out])
    *records, summary = _json_lines(capsys)
    assert [r["key"] for r in records] == ["sample_0_clean_inf", "sample_1_noisy_5"]
    assert set(summary) == {"n", "mean_auc_topk", "mean_auc_random", "mean_auc_gap",
                            "gap_ci95", "frac_gap_positive", "mode", "fill", "fractions"}
    assert summary["n"] == 2 and summary["fractions"] == [0.05, 0.2]
    with open(out) as fh:
        assert [json.loads(line) for line in fh] == records + [summary]

    params, _ = shared_params(tiny_config, seed=9)
    port_archive, ref_archive = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    save_params(port_archive, params, port_cfg(tiny_config))
    jax_save_params(ref_archive, jax_load_params(port_archive), jax_load_config(port_archive))
    cli(["faithfulness", "--device", "cpu", "--params", ref_archive, *argv])
    got = _json_lines(capsys)
    jax_cli(["faithfulness", "--params", ref_archive, *argv])
    assert got == _json_lines(capsys)
