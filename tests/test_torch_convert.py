"""The port's checkpoint converters against the reference package's on the
CPU: the NeMo converter on a synthetic NeMo-keyed state_dict and a .nemo
tar round trip, and both HF converters on tiny randomly initialised
transformers models (no weights fetched), whose own logits the port's
forward reproduces; and ``--hf`` on a ``save_pretrained`` directory."""

import io
import json
import tarfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.models import convert_hf as jax_convert_hf
from asr_shap.models.conformer import conformer_logits as jax_conformer_logits
from asr_shap.models.nemo_ctc import convert_nemo_state_dict as jax_convert_nemo
from asr_shap.models.nemo_ctc import load_nemo_checkpoint as jax_load_nemo
from asr_shap.models.nemo_ctc import nemo_conformer_config as jax_nemo_config
from asr_shap_torch.cli import main as cli
from asr_shap_torch.core.params_io import params_to_jax
from asr_shap_torch.models import convert_hf
from asr_shap_torch.models.nemo_ctc import (
    convert_nemo_state_dict,
    load_nemo_checkpoint,
    nemo_ctc_logits,
)
from asr_shap_torch.models.w2v2_conformer import w2v2_conformer_logits
from asr_shap_torch.models.wav2vec2 import wav2vec2_logits
from torch_port_configs import port_cfg

def tiny_nemo_config():
    return jax_nemo_config(vocab_size=16, hidden_size=64, num_layers=2, num_attention_heads=2,
                           input_dim=16, conv_kernel_size=7)


def nemo_state_dict(cfg, rng):
    """A state_dict with NeMo's key names (ConformerEncoder + ConvASRDecoder)
    and random values."""
    d = cfg.hidden_size
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    ffn = d * cfg.ffn_expansion
    ch = cfg.subsampling_conv_channels or d
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)

    # pre_encode: Sequential(Conv2d, ReLU, Conv2d, ReLU) -> indices 0, 2
    c_in = 1
    for i in (0, 2):
        sd[f"encoder.pre_encode.conv.{i}.weight"] = t(ch, c_in, 3, 3)
        sd[f"encoder.pre_encode.conv.{i}.bias"] = t(ch)
        c_in = ch
    sd["encoder.pre_encode.out.weight"] = t(d, ch * cfg.subsampled_length(cfg.input_dim))
    sd["encoder.pre_encode.out.bias"] = t(d)

    for li in range(cfg.num_layers):
        p = f"encoder.layers.{li}"
        for nrm in ("norm_feed_forward1", "norm_self_att", "norm_conv",
                    "norm_feed_forward2", "norm_out"):
            sd[f"{p}.{nrm}.weight"] = 1.0 + t(d)
            sd[f"{p}.{nrm}.bias"] = t(d)
        for ff in ("feed_forward1", "feed_forward2"):
            sd[f"{p}.{ff}.linear1.weight"] = t(ffn, d)
            sd[f"{p}.{ff}.linear1.bias"] = t(ffn)
            sd[f"{p}.{ff}.linear2.weight"] = t(d, ffn)
            sd[f"{p}.{ff}.linear2.bias"] = t(d)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            sd[f"{p}.self_attn.{proj}.weight"] = t(d, d)
            sd[f"{p}.self_attn.{proj}.bias"] = t(d)
        sd[f"{p}.self_attn.linear_pos.weight"] = t(d, d)
        sd[f"{p}.self_attn.pos_bias_u"] = t(nh, hd)
        sd[f"{p}.self_attn.pos_bias_v"] = t(nh, hd)
        sd[f"{p}.conv.pointwise_conv1.weight"] = t(2 * d, d, 1)
        sd[f"{p}.conv.pointwise_conv1.bias"] = t(2 * d)
        sd[f"{p}.conv.pointwise_conv2.weight"] = t(d, d, 1)
        sd[f"{p}.conv.pointwise_conv2.bias"] = t(d)
        sd[f"{p}.conv.depthwise_conv.weight"] = t(d, 1, cfg.conv_kernel_size)
        sd[f"{p}.conv.depthwise_conv.bias"] = t(d)
        sd[f"{p}.conv.batch_norm.weight"] = 1.0 + t(d)
        sd[f"{p}.conv.batch_norm.bias"] = t(d)
        sd[f"{p}.conv.batch_norm.running_mean"] = t(d)
        sd[f"{p}.conv.batch_norm.running_var"] = torch.abs(t(d)) + 1.0
        sd[f"{p}.conv.batch_norm.num_batches_tracked"] = torch.tensor(0)
    sd["decoder.decoder_layers.0.weight"] = t(cfg.vocab_size, d, 1)
    sd["decoder.decoder_layers.0.bias"] = t(cfg.vocab_size)
    return sd


def assert_same_tree(port_params, ref_tree):
    """The port's params, stacked as the reference stacks them, equal the
    reference's leaf for leaf."""
    got = params_to_jax(port_params)
    ref = jax.tree.map(np.asarray, ref_tree)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_nemo_converter_matches_reference(rng):
    """The same NeMo-keyed state_dict through both converters: the same
    leaves, and logits of the converted params within the model tests'
    tolerance."""
    cfg = tiny_nemo_config()
    sd = nemo_state_dict(cfg, rng)
    params = convert_nemo_state_dict(sd, port_cfg(cfg), device="cpu")
    ref = jax_convert_nemo(sd, cfg)
    assert_same_tree(params, ref)
    x = rng.standard_normal((1, 31, cfg.input_dim)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, a: jax_conformer_logits(p, cfg, a))(ref, jnp.asarray(x)))
    got = nemo_ctc_logits(params, port_cfg(cfg), torch.from_numpy(x))
    assert got.shape == want.shape == (1, cfg.subsampled_length(31), cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


def test_load_nemo_checkpoint_tar_round_trip(tmp_path, rng):
    """A .nemo archive (a tar of model_config.yaml, model_weights.ckpt and
    vocab.txt) loads into the same (params, config, vocab) in both
    packages, without the NeMo toolkit."""
    yaml = pytest.importorskip("yaml")
    cfg = tiny_nemo_config()
    sd = nemo_state_dict(cfg, rng)
    model_cfg = {"encoder": {"d_model": cfg.hidden_size, "n_layers": cfg.num_layers,
                             "n_heads": cfg.num_attention_heads, "feat_in": cfg.input_dim,
                             "conv_kernel_size": cfg.conv_kernel_size},
                 "decoder": {"num_classes": cfg.vocab_size - 1}}
    vocab = [f"▁w{i}" for i in range(cfg.vocab_size - 1)]
    path = tmp_path / "tiny.nemo"
    with tarfile.open(path, "w") as tar:
        def add(name, data: bytes):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        add("./model_config.yaml", yaml.safe_dump(model_cfg).encode())
        buf = io.BytesIO()
        torch.save(sd, buf)
        add("./model_weights.ckpt", buf.getvalue())
        add("./vocab.txt", "\n".join(vocab).encode())

    params, loaded_cfg, loaded_vocab = load_nemo_checkpoint(str(path), device="cpu")
    ref_params, ref_cfg, ref_vocab = jax_load_nemo(str(path))
    assert loaded_cfg == port_cfg(ref_cfg) == port_cfg(cfg)
    assert loaded_vocab == ref_vocab == vocab
    assert_same_tree(params, ref_params)


def _offline(monkeypatch):
    """No hub access: a save_pretrained directory is read from disk."""
    import huggingface_hub.constants as hub_constants

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(hub_constants, "HF_HUB_OFFLINE", True)


HF_TINY = dict(vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=64, conv_dim=(32, 32), conv_stride=(5, 2),
               conv_kernel=(10, 3), num_conv_pos_embeddings=16,
               num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("family", ["wav2vec2", "w2v2-conformer"])
def test_hf_converters_match_reference_and_model(tmp_path, monkeypatch, rng, family):
    """A tiny randomly initialised Wav2Vec2ForCTC (the weight-normed
    positional conv in torch's parametrized layout) or rel-pos
    Wav2Vec2ConformerForCTC, saved and read back by both packages'
    ``load_pretrained*``: the same config and leaves, and the port's logits
    equal to the transformers model's own."""
    transformers = pytest.importorskip("transformers")
    _offline(monkeypatch)
    torch.manual_seed(0)
    if family == "wav2vec2":
        model = transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(**HF_TINY))
        load, jax_load, logits_fn = (convert_hf.load_pretrained, jax_convert_hf.load_pretrained,
                                     wav2vec2_logits)
        assert any("parametrizations.weight.original0" in k for k in model.state_dict())
    else:
        # swish, as the published checkpoints: both packages' conv module
        # runs SiLU whatever hidden_act says, where HF's follows hidden_act
        model = transformers.Wav2Vec2ConformerForCTC(transformers.Wav2Vec2ConformerConfig(
            **HF_TINY, position_embeddings_type="relative", conv_depthwise_kernel_size=7,
            hidden_act="swish"))
        load, jax_load, logits_fn = (convert_hf.load_pretrained_conformer,
                                     jax_convert_hf.load_pretrained_conformer,
                                     w2v2_conformer_logits)
    model.eval()
    path = str(tmp_path / family)
    model.save_pretrained(path)
    params, cfg = load(path, device="cpu")
    ref_params, ref_cfg = jax_load(path)
    assert cfg == port_cfg(ref_cfg)
    assert_same_tree(params, ref_params)
    x = rng.standard_normal((1, 1600)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x)).logits.numpy()
    got = logits_fn(params, cfg, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)


def test_cli_hf_transcribes_a_saved_checkpoint(tmp_path, monkeypatch, capsys, rng):
    """``transcribe --hf DIR`` on the CPU reads the checkpoint through the
    converter and prints the transformers model's own greedy transcript."""
    from asr_shap_torch.audio.normalize import zero_mean_unit_var
    from asr_shap_torch.ops.ctc import ctc_decode_batch

    transformers = pytest.importorskip("transformers")
    _offline(monkeypatch)
    torch.manual_seed(1)
    model = transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(**HF_TINY)).eval()
    path = str(tmp_path / "hf")
    model.save_pretrained(path)
    clip = str(tmp_path / "clip.npy")
    audio = rng.standard_normal(1600).astype(np.float32)
    np.save(clip, audio)
    cli(["transcribe", "--device", "cpu", "--hf", path, clip])
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    with torch.no_grad():
        logits = model(zero_mean_unit_var(torch.from_numpy(audio))[None]).logits
    assert line["transcript"] == ctc_decode_batch(logits)[0]
    assert line["frames"] == logits.shape[1]
