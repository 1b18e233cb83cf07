"""NeMo-style BPE-CTC Conformer: the ``EncDecCTCModelBPE`` capability.

The port of ``asr_shap/models/nemo_ctc.py``. The model is assembled from
``models/conformer.py``:

  mel features [B, T, F]
    -> striding conv subsampler   (``conformer.conv_subsampling``, x4)
    -> sqrt(d) input scaling      (NeMo RelPositionalEncoding's xscale)
    -> rel-pos conformer layers   (Transformer-XL attention: the full-bias
                                   flash kernels under attention_impl="pallas")
    -> linear CTC head over the BPE vocab, blank LAST (NeMo's convention,
       unlike wav2vec2's blank-first pad token)

plus a reader of ``.nemo`` checkpoints: a tar archive holding
``model_config.yaml`` and a torch ``model_weights.ckpt``, read with tarfile,
torch and yaml (imported when called), no NeMo toolkit. The key map follows
NeMo's ConformerEncoder and ConvASRDecoder module tree.
"""

from __future__ import annotations

import io
import tarfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from asr_shap_torch.core.config import ConformerConfig
from asr_shap_torch.core.device import resolve_device
from asr_shap_torch.core.params_io import StateDictReader
from asr_shap_torch.models.conformer import (
    PLAIN_RULES,
    Rules,
    conformer_logits,
    init_conformer_params,
)
from asr_shap_torch.ops.ctc import ctc_greedy_decode

Params = Dict[str, Any]


def nemo_conformer_config(vocab_size: int = 128, hidden_size: int = 512,
                          num_layers: int = 17, num_attention_heads: int = 8,
                          input_dim: int = 80, conv_kernel_size: int = 31) -> ConformerConfig:
    """The NeMo conformer-CTC architecture; the defaults are
    stt_en_conformer_ctc_large's widths (a checkpoint's own come from its
    .nemo config in ``load_nemo_checkpoint``)."""
    return ConformerConfig(
        vocab_size=vocab_size + 1,  # + the trailing blank
        input_dim=input_dim,
        hidden_size=hidden_size,
        num_layers=num_layers,
        num_attention_heads=num_attention_heads,
        ffn_expansion=4,
        conv_kernel_size=conv_kernel_size,
        conv_norm="batch",
        pos_encoding="relative",
        subsampling="striding",
        subsampling_factor=4,
        input_scale=True,
    )


def init_nemo_ctc_params(seed: int, config: ConformerConfig,
                         device: str | torch.device = "cuda") -> Params:
    return init_conformer_params(seed, config, device)


def nemo_ctc_logits(params: Params, config: ConformerConfig, features: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    rules: Rules = PLAIN_RULES, remat: bool = False) -> torch.Tensor:
    """Log-mel features [..., T, F] -> BPE CTC logits [..., subsampled_length(T),
    vocab + 1], float32, blank last (``conformer.conformer_logits``; ``remat``
    recomputes each conformer layer in the backward)."""
    return conformer_logits(params, config, features, lengths, rules, remat)


# ----------------------------------------------------------------- BPE vocab

def bpe_ids_to_text(ids, keep, vocab: Sequence[str]) -> str:
    """Collapsed BPE piece ids -> text, with sentencepiece's "▁" word
    boundary (the NeMo tokenizer's decode)."""
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else np.asarray(keep)
    pieces = [vocab[i] for i, k in zip(ids, keep) if k]
    return "".join(pieces).replace("▁", " ").strip()


def nemo_ctc_decode(logits: torch.Tensor, vocab: Sequence[str],
                    lengths: Optional[Sequence[int]] = None) -> List[str]:
    """Greedy BPE-CTC decode of a logits batch [B, T, V]; the blank is the
    last index. ``lengths`` (frames per row) masks the padded frames."""
    ids, keep = ctc_greedy_decode(logits, logits.shape[-1] - 1)
    ids, keep = ids.cpu().numpy(), keep.cpu().numpy()
    if lengths is not None:
        keep = keep & (np.arange(ids.shape[1])[None, :] < np.asarray(lengths)[:, None])
    return [bpe_ids_to_text(i, k, vocab) for i, k in zip(ids, keep)]


# ---------------------------------------------------------------- converter

def convert_nemo_state_dict(sd: Mapping[str, Any], config: ConformerConfig,
                            device: str | torch.device = "cuda") -> Params:
    """NeMo EncDecCTCModelBPE state_dict -> port params (float32 on
    ``device``, one dict per layer).

    Keys per NeMo's ConformerEncoder (the pre_encode striding subsampler,
    layers.N.{norm_feed_forward1, feed_forward1, norm_self_att, self_attn,
    norm_conv, conv, norm_feed_forward2, feed_forward2, norm_out}) and
    ConvASRDecoder (decoder_layers.0, a 1x1 Conv1d, blank last). A missing
    linear or depthwise bias is zero."""
    cfg = config
    r = StateDictReader(sd, resolve_device(device), zero_bias=True)

    # the subsampler: Conv2d [C_out, C_in, 3, 3] -> HWIO; NeMo's Sequential
    # interleaves the activations, so the convs are its even entries
    convs, i = [], 0
    while f"encoder.pre_encode.conv.{i}.weight" in sd:
        convs.append({"kernel": r.tensor(
                          r.array(f"encoder.pre_encode.conv.{i}.weight").transpose(2, 3, 1, 0)),
                      "bias": r.get(f"encoder.pre_encode.conv.{i}.bias")})
        i += 2

    nh, hd = cfg.num_attention_heads, cfg.head_dim
    layers = []
    for li in range(cfg.num_layers):
        pre = f"encoder.layers.{li}"
        conv = f"{pre}.conv"
        layers.append({
            "ffn1": {"norm": r.norm(f"{pre}.norm_feed_forward1"),
                     "in": r.linear(f"{pre}.feed_forward1.linear1"),
                     "out": r.linear(f"{pre}.feed_forward1.linear2")},
            "attn": {
                "norm": r.norm(f"{pre}.norm_self_att"),
                **{name: r.linear(f"{pre}.self_attn.linear_{name}")
                   for name in ("q", "k", "v", "out")},
                "pos": {"kernel": r.tensor(r.array(f"{pre}.self_attn.linear_pos.weight").T)},
                "bias_u": r.get(f"{pre}.self_attn.pos_bias_u").reshape(nh, hd),
                "bias_v": r.get(f"{pre}.self_attn.pos_bias_v").reshape(nh, hd),
            },
            "conv": {
                "norm": r.norm(f"{pre}.norm_conv"),
                "pointwise1": r.pointwise(f"{conv}.pointwise_conv1"),
                "depthwise": r.conv1d(f"{conv}.depthwise_conv"),
                "bn": {**r.norm(f"{conv}.batch_norm"),
                       "mean": r.get(f"{conv}.batch_norm.running_mean"),
                       "var": r.get(f"{conv}.batch_norm.running_var")},
                "pointwise2": r.pointwise(f"{conv}.pointwise_conv2"),
            },
            "ffn2": {"norm": r.norm(f"{pre}.norm_feed_forward2"),
                     "in": r.linear(f"{pre}.feed_forward2.linear1"),
                     "out": r.linear(f"{pre}.feed_forward2.linear2")},
            "final_norm": r.norm(f"{pre}.norm_out"),
        })
    return {"subsampling": {"convs": convs, "out": r.linear("encoder.pre_encode.out")},
            "layers": layers,
            "head": r.pointwise("decoder.decoder_layers.0")}


def load_nemo_checkpoint(path: str, device: str | torch.device = "cuda"
                         ) -> Tuple[Params, ConformerConfig, List[str]]:
    """Read a ``.nemo`` tar archive -> (params on ``device``, config, BPE
    vocab). Needs pyyaml, imported here: without it this raises ImportError
    before reading anything."""
    import yaml

    device = resolve_device(device)
    with tarfile.open(path) as tar:
        names = tar.getnames()

        def member(suffix):
            match = [n for n in names if n.endswith(suffix)]
            if not match:
                raise FileNotFoundError(f"{suffix} not found in {path}")
            return tar.extractfile(match[0]).read()

        model_cfg = yaml.safe_load(io.BytesIO(member("model_config.yaml")))
        ckpt = torch.load(io.BytesIO(member("model_weights.ckpt")), map_location="cpu",
                          weights_only=True)
        vocab: List[str] = []
        if any(n.endswith("vocab.txt") for n in names):
            vocab = member("vocab.txt").decode("utf-8").splitlines()

    enc = model_cfg["encoder"]
    cfg = nemo_conformer_config(
        vocab_size=int(model_cfg["decoder"]["num_classes"]),
        hidden_size=int(enc["d_model"]),
        num_layers=int(enc["n_layers"]),
        num_attention_heads=int(enc["n_heads"]),
        input_dim=int(enc["feat_in"]),
        conv_kernel_size=int(enc.get("conv_kernel_size", 31)),
    )
    return convert_nemo_state_dict(ckpt, cfg, device), cfg, vocab
