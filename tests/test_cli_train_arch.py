"""The CLI's train subcommand on the conformer family."""

import json
import os


def test_train_conformer_arch_embeds_config(tmp_path, capsys):
    """train --arch w2v2-conformer trains the conformer family and embeds
    its config in the archive, so the archive reloads as a conformer."""
    from asr_shap.cli import build_parser
    from asr_shap.core.config import Wav2Vec2ConformerConfig
    from asr_shap.core.params_io import load_config

    out = str(tmp_path / "conf.npz")
    args = build_parser().parse_args([
        "train", "--arch", "w2v2-conformer", "--tiny", "--random-init",
        "--epochs", "1", "--batches-per-epoch", "1", "--batch-size", "2",
        "--clip-seconds", "0.25", "--out", out,
    ])
    args.fn(args)
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["params_path"] == out
    assert summary["epochs_run"] == 1
    assert os.path.exists(out)
    assert isinstance(load_config(out), Wav2Vec2ConformerConfig)
