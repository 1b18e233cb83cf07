"""Typed configuration of the PyTorch port.

A copy of the configs of ``asr_shap.core.config``, with the same field
names and defaults, so an archive's embedded config and a test's config
mean the same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# The 32-symbol CTC vocabulary of facebook/wav2vec2-base-960h.
WAV2VEC2_VOCAB: Tuple[str, ...] = (
    "<pad>", "<s>", "</s>", "<unk>", "|",
    "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U",
    "M", "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X",
    "J", "Q", "Z",
)
PAD_ID = 0
WORD_DELIMITER_ID = 4  # "|"


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Architecture of a Wav2Vec2-style CTC model; defaults reproduce
    ``facebook/wav2vec2-base-960h``."""

    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer"
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False  # base: post-LN encoder layers
    layer_norm_eps: float = 1e-5
    feat_proj_dim: int = 512

    # Numerics. "float32" or "bfloat16": the compute dtype of activations
    # and params (a bf16 copy of the float32 params); norm statistics, the
    # kernels' sums, the logits and the explainer's phi stay float32. The
    # Wav2Vec2-Conformer takes float32 only.
    dtype: str = "float32"
    # "highest": float32 matmuls and convolutions without TF32 (cuBLAS and
    # cuDNN), bf16 GEMMs summed in float32; "default" lets both use TF32
    # (core/device.py). The port's float32 kernels are 3xTF32 under either.
    matmul_precision: str = "highest"
    # "xla": plain PyTorch attention; "pallas": the hand-written flash
    # kernels (kernels/flash_attention.py); "auto" resolves to "xla".
    attention_impl: str = "xla"
    remat_policy: str = "full"
    # "lax": F.conv1d everywhere; "pallas": the hand-written dgrad kernel
    # (kernels/conv_dgrad.py) for eligible feature-encoder layers; "gemm":
    # stride-blocked GEMMs both ways; "hybrid": F.conv1d forward, GEMM
    # backward (models/wav2vec2.py::_conv1d).
    conv_impl: str = "lax"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def frames_for_samples(self, n: int) -> int:
        """Output frame count of the conv feature encoder for n samples."""
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


@dataclasses.dataclass(frozen=True)
class Wav2Vec2ConformerConfig(Wav2Vec2Config):
    """Wav2Vec2-Conformer CTC model: conformer blocks over the wav2vec2 conv
    feature encoder. Defaults reproduce
    ``facebook/wav2vec2-conformer-rel-pos-large-960h-ft``;
    ``position_embeddings_type="rotary"`` gives the rope-large variant."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    conv_bias: bool = True
    feat_extract_norm: str = "layer"
    do_stable_layer_norm: bool = True
    feat_proj_dim: int = 512
    position_embeddings_type: str = "relative"  # "relative" | "rotary" | "none"
    rotary_embedding_base: int = 10_000
    conv_depthwise_kernel_size: int = 31
    hidden_act: str = "swish"  # FFN activation; "swish"/"silu", else GELU


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """Conformer CTC encoder on log-mel features (``models/conformer.py``):
    the torchaudio-style Conformer of the mel SHAP study at its defaults, and
    the NeMo BPE-CTC Conformer through ``models/nemo_ctc.py``'s preset. It
    has no ``matmul_precision``: the forward takes "highest" for float32 and
    "default" for bf16."""

    vocab_size: int = 32
    input_dim: int = 80  # mel bins
    hidden_size: int = 256
    num_layers: int = 4
    num_attention_heads: int = 4
    ffn_expansion: int = 4
    conv_kernel_size: int = 31
    conv_norm: str = "batch"  # "batch" | "group"
    num_conv_groups: int = 1
    dropout: float = 0.0
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"
    attention_impl: str = "xla"
    # "none" (torchaudio style) or "relative" (NeMo-style Transformer-XL
    # rel-pos attention with per-layer u/v biases)
    pos_encoding: str = "none"
    # "striding": stacked 2-D convs, stride 2 each, then a linear onto
    # hidden_size (NeMo); "none" feeds the mel frames directly
    subsampling: str = "none"
    subsampling_factor: int = 4
    subsampling_conv_channels: int = 0  # 0 = hidden_size
    # multiply the encoder input by sqrt(hidden_size) (NeMo's xscale)
    input_scale: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def subsampling_layers(self) -> int:
        n, f = 0, 1
        while f < self.subsampling_factor:
            f *= 2
            n += 1
        return n

    def subsampled_length(self, t: int) -> int:
        """Output frame count of the striding subsampler for t input frames
        (kernel 3, stride 2, pad 1 per stage)."""
        for _ in range(self.subsampling_layers):
            t = (t + 2 - 3) // 2 + 1
        return t


@dataclasses.dataclass(frozen=True)
class ExplainerConfig:
    """Expected-gradients settings (the other explainers' fields are kept
    so configs match the reference package field for field)."""

    nsamples: int = 200
    num_background: int = 5
    background_sigma: float = 0.01
    method: str = "grad"
    aggregation: str = "max"
    token_timestep: int = 0
    token_id: int = 0
    draw_chunk: int = 8
    output_chunk: int = 0     # 0 = all output frames in one batched VJP
    remat: bool = True
    host_draw_chunk: int = 0
    lime_num_samples: int = 500
    lime_keep_prob: float = 0.5
    lime_ridge_alpha: float = 1.0
    lime_num_segments: int = 64
    kmeans_background: int = 0
    kernel_num_segments: int = 32


@dataclasses.dataclass(frozen=True)
class TestSetConfig:
    """Controlled clean+noisy test-set generation."""

    num_samples: int = 20
    snrs_db: Tuple[float, ...] = (5.0, 2.0, 1.0)
    min_length: int = 100_000
    max_length: int = 0
    sample_rate: int = 16_000
    seed: int = 0
    noise_kind: str = "white"


TestSetConfig.__test__ = False  # keep pytest from collecting the dataclass


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    """eta_raw / WER settings; "strict" ITM is E_c > E_u, "half" is
    E_c > 0.5 * E_u."""

    segment_ms: float = 0.0625
    percentile: float = 99.0
    itm_variant: str = "strict"
    sample_rate: int = 16_000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Noise-robust CTC fine-tuning (``pipeline/train.py``)."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    num_epochs: int = 10
    batch_size: int = 8
    max_audio_len: int = 160_000
    max_label_len: int = 256
    snrs_db: Tuple[float, ...] = (-5.0, 0.0, 5.0, 10.0, 15.0)
    early_stopping_patience: int = 3
    early_stopping_min_delta: float = 0.0
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    grad_clip_norm: float = 1.0
    seed: int = 0
    freeze_feature_encoder: bool = True


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process mesh for sharded explanation (``parallel/mesh.py``): the
    expected-gradients draws and the test set's samples shard over the
    "data" axis; the "model" axis splits the params Megatron-style
    (``parallel/tp.py``)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 0   # 0 = world size // model_parallel
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle for end-to-end runs. ``sample_batch`` is the
    samples explained per group call (0: ``run_shap._auto_group_size``);
    ``crash_retries`` and ``crash_backoff_s`` govern the recovery from a
    lost device (``pipeline/run_shap.py``)."""

    model: Wav2Vec2Config = Wav2Vec2Config()
    explainer: ExplainerConfig = ExplainerConfig()
    testset: TestSetConfig = TestSetConfig()
    metric: MetricConfig = MetricConfig()
    mesh: MeshConfig = MeshConfig()
    data_dir: str = "data"
    seed: int = 0
    sample_batch: int = 0
    crash_retries: int = 3
    crash_backoff_s: float = 60.0
