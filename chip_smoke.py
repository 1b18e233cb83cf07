#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr_shap_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Four paths are driven, each through run_shap_pipeline at full width with
random weights from a seed: the base path (Wav2Vec2-base, kernels K1-K4),
the conformer slice (Wav2Vec2-Conformer rel-pos-large, kernels K1 and the
full-bias flash kernels K2f, K3b, K4f), the bf16 path (Wav2Vec2-base
with dtype="bfloat16", matmul_precision="default": the bf16 kernels of
K1-K4) and the bf16 conformer (the conformer with the same numerics: the
bf16 K1, K2f, K3b and K4f); then the base path (and, for DeepSHAP, the
conformer) again through the other explainers, DeepSHAP, KernelSHAP and
LIME, the compare and visualize commands, the mel Conformer family (the
NeMo BPE-CTC Conformer and the torchaudio-style Conformer, on log-mel
features, through the library calls a user makes), CTC training of both
Wav2Vec2 families (``train_synthetic`` and ``python -m asr_shap_torch
train``), run-shap's scale-out, and last data-parallel training. Phases,
each reported on its own lines:

1. the card's name and power limit (nvidia-smi); build every kernel from
   asr_shap_torch/csrc with nvcc, one process per source, all at once; log
   each bf16 backward kernel's registers, spills, shared memory and blocks
   per SM, and check its SASS: bf16 m16n8k16 tensor-core products
   (HMMA.16816.F32.BF16) and no other, so no TF32 product; the same for
   the bf16 K1 (csrc/conv_dgrad_bf16.cu), whose SASS must hold bf16
   warpgroup products (HGMMA ... F32.BF16) and no HMMA; and the same as the
   bf16 backward's for the bf16 forward (csrc/flash_fwd_bf16.cu: K2-bf16,
   K2f-bf16, at both block heights);
2. hold each kernel against its plain PyTorch version on the card, float32,
   at its path's shapes, with the tolerance stated beside it (the full-bias
   kernels with a rel-pos-like bias, and with the same bias masked; the
   flash forward also at 1, 100, 500 and 1,499 keys; K3 and K4, and K3b and
   K4f with a rel-pos-like bias, also at one and 37 cotangent rows per
   residual row, five clips with a mask length each, 100 and 500 keys and
   D = 32; K1, K3 and K4, K3b and K4f and their plain versions also against
   float64; K2 also at the sweep's batched shapes, 8 clips, no bias,
   T = 149 and 312, D = 64 and 32);
3. drive each path: run_shap_pipeline on a 48,000-sample clip and its 5 dB
   white-noise mix, 4 expected-gradients draws each, with the launch counts
   set to 0 just before and read just after; check phi, the store and the
   path's kernels' counts, and score each sample (transcript, confidence,
   eta_raw, WER);
4. check each path's result against a reference: phi of one full-width draw
   through the kernels against the same draw through plain PyTorch, and a
   narrow model on the card against the CPU (for the conformer, the trained
   archive artifacts/params_synthetic_conformer.npz through the pipeline,
   phi and transcript);
5. drive the command line (``asr_shap_torch.cli.main``, in this process),
   with the launch counts set to 0 just before each command and read just
   after: ``run-shap`` then ``sweep`` on a full-width Wav2Vec2-base archive
   (the base path's random weights, written by ``save_params`` with the
   kernel impls), its sweep again on the CPU (same records), ``transcribe``
   and ``metric`` against the sweep; the trained study archive (heads of
   32) on 2 clips x {clean, 5, 1 dB} at 100,000 samples, its per-SNR WER and
   eta_raw printed as information; and the trained conformer archive
   through ``run-shap`` and ``sweep --arch w2v2-conformer``;
6. time each kernel with CUDA events beside its bound, its plain version and
   one library call (K2 and K2f also by device time under torch.profiler,
   and at 16 and 32 query rows per block); time each path per draw,
   with its peak device memory, then profile two more draws (torch.profiler:
   device busy share, time by kernel group). A kernel's times in the JSON
   line are per draw of its path: the sum over the launches one draw makes
   (K1 once per eligible conv layer, the flash forward twice per encoder
   layer: the forward and remat's recompute, the flash backwards once);
   its "launches" is the count from its path's pipeline run of
   phase 3 (the command line's counts are logged, "cli" lines). Every kernel (K1, the flash forward K2 and K2f, the flash
   backward K3, K4, K3b and K4f) runs on the tensor cores in 3xTF32, so
   its bound is three TF32 products per float32 product at the TF32 peak,
   or its bytes ("operations (3xTF32)" or "bytes"); the log gives its
   float32 FMA bound beside it. The flash backward's yardstick is SDPA's
   backward alone on the same inputs (its forward run once, outside the
   timing); forward plus backward is logged beside it;
7. the bf16 path, after the others: K1-K4 in bf16 against their plain
   versions at its shapes (each bf16 output within one bf16 ulp, lse and dd
   at the float32 tolerances; K1 also at 144 edge shapes: 1 and 3 clips,
   T_out 1-300, (K, s) (3, 2), (2, 2), (5, 3), three channel pairs, rows
   past the taps' reach; K2-K4 also at D = 32, T = 312, K2 also at 1, 100,
   500 and 1,499 keys and at the sweep's 8-clip batches, K3 and K4 over the
   backward's shape sweep) and against float64 on the same bf16 inputs (at
   most 1.25x the plain version's error, K1 at each of its main-path and
   edge shapes; lse 2x); run_shap_pipeline with
   the exact launch counts of its bf16 kernels and none of a float32
   kernel; one draw through the bf16 kernels, through plain bf16 PyTorch
   and in float32 ("phi bf16" lines, with the |phi| checksum's moves);
   each bf16 kernel's times beside its bound at the bf16 rate, its plain
   version and a bf16 library call (for the backward, the SDPA backend
   that ran, named from its device kernels); the bf16 slice per draw; and
   ``python -m asr_shap_torch bench --attn pallas`` at its bf16 defaults
   ("cli bench" lines). Its JSON entries are K1-bf16 to K4-bf16;
8. the bf16 conformer, last: K2f, K3b and K4f in bf16 against their plain
   versions at its shapes and the trained archive's (D = 32), plain and
   masked, over the backward's shape sweep, and against float64 (o, dq,
   dk, dv at most 1.25x the plain version's error; lse and d(bias) 2x);
   run_shap_pipeline with the exact launch counts of its four kernels and
   no other kernel; the three-way draw ("phi bf16 conformer" lines); each
   kernel's times beside its bound at the bf16 rate, its plain version and
   SDPA in bf16 with a bf16 mask (its backend named); the depthwise conv's
   dgrad in the library's bf16 and on float32 copies; the slice per draw beside the
   float32 conformer's; and ``run-shap`` then ``sweep`` on the trained
   conformer archive switched to bf16 ("cli conformer bf16" lines). Its
   JSON entries are K2f-bf16, K3b-bf16 and K4f-bf16;
9. the explainers: every kernel at the shapes DeepSHAP, KernelSHAP,
   LIME and faithfulness give it, in float32 and bf16, against its plain
   version at its tolerance and timed beside its bound and a library call
   (K1 at DeepSHAP's dual batch of 2 x 149 rows; K3/K4 and K3b/K4f at a
   residual batch of 2; K2 at 16 and 21 clips, K2f at 16; "timing
   explainers" lines); DeepSHAP (5 background rows), KernelSHAP and LIME
   (64 coalitions of 32 segments) through run_shap_pipeline on the base
   path in float32 and bf16, and DeepSHAP on the conformer, each with the
   exact launch counts of its kernels; DeepSHAP's phi of one background
   row and KernelSHAP's and LIME's segment values, model output and base
   value (intercept) through the kernels against plain PyTorch (2e-3 of
   max|.|); in bf16 the rule of phase 7; wall, device-busy time and peak
   memory per explained sample ("explainers time" lines); and run-shap
   --method deep, kernel and lime, then faithfulness over each store, on
   the trained conformer archive on the card and on the CPU (phi within
   2e-3 of max|phi|, equal faithfulness records);
10. the compare and visualize commands, last: every kernel at the shapes
   ``compare`` gives it on a 32,000-sample clip (T_out = 99), in float32
   and bf16, against its plain version and timed ("timing compare" lines:
   K1 at 99 rows, K3/K4 at N = 1,188, K2 at 1 and 16 clips, K2f/K3b/K4f at
   the conformer archive's 3 heads of 32); lime_shap_comparison at full
   width through the kernels against plain PyTorch with 4 explicit draws
   and 64 explicit LIME masks (phi and LIME within 2e-3 of max|.|, r's
   within 1e-3, exact launch counts); ``compare`` at its defaults (200
   draws, 500 perturbations) on the base archive in float32 and bf16, with
   exact launch counts, walls, peak memory and 4 profiled draws ("compare
   time", "compare profile" lines); its two wavs from the card's phi
   against the CPU's; ``compare --arch w2v2-conformer`` on the trained
   conformer archive on the card and the CPU; ``visualize``'s view of the
   study store on the card and the CPU; the mel front end and Griffin-Lim
   on the card and the CPU; and each drawing command (``--plot``,
   ``compare --out-dir``, ``visualize``) refusing before any work where
   matplotlib does not import, or writing its figure where it does;
11. the mel Conformer family, last, on the log-mel features of the two
   clips ([301, 80], N = 24,080; the background is the features of 5
   seeded white-noise clips): the NeMo BPE-CTC Conformer at
   stt_en_conformer_ctc_large's widths (17 layers, d 512, 8 heads of 64,
   x4 striding subsampler: T_out = 76, seeded u/v, norms and BatchNorm
   statistics) in float32 (logits and BPE transcripts of both clips
   against the plain twin; expected_gradients with the exact launches of
   K2f/K3b/K4f and phi within 2e-3 of max|phi| of the plain twin; wall per
   draw, profile, peak; the .nemo converter on a NeMo-keyed state_dict of
   the same params, logits bit-equal) and in bf16 under "default" (the
   bf16 counters' exact launches, the bf16 rule on one draw three ways);
   ``ConformerConfig()`` (no positions, T_out = 301) through K2/K3/K4 (EG
   against the plain twin, a masked 2-clip batch, DeepSHAP on its
   group-norm variant, each within 2e-3); subsampler conv2's dgrad in bf16
   both ways; and the flash kernels at these shapes, float32 and bf16
   ("mel" and "timing mel conformer" lines). Its launches are the JSON
   line's ``launches_mel``;
12. training, last, on batches of 8 synthetic-corpus clips of 32,000
   samples (T = 99): ``train_synthetic`` on Wav2Vec2-base in float32 (one
   epoch of 4 batches, one validation batch, the feature encoder trained:
   the exact launches of K1-K4 and no other kernel, finite losses); one
   step's loss and gradients through the kernels against plain PyTorch
   (each leaf within 1e-3 of its max|g|, floored at 1e-4 of the model's);
   the same with a frozen feature encoder (no K1 launch, the encoder
   bit-equal after a step); two bf16 steps (exact bf16 launches, float32
   masters and state) and a bf16 step's gradients no further from
   float32's than plain bf16's; two rel-pos conformer steps (exact K1,
   K2f, K3b, K4f) and its gradients against plain PyTorch, the position
   leaves that K3b's d(bias) feeds on lines of their own; ``ctc_loss``
   against F.ctc_loss on the card; ``train --params`` on the base archive
   (exact launches, the archive equal to what train_synthetic returned);
   the wall per step of each path (median of 5 after 2 warm-ups),
   utterances and audio seconds per second, peak memory, two profiled
   steps, the CTC loss and AdamW alone; every kernel at the step's shapes
   beside its bound, plain version and library call ("train", "timing
   train" lines). Its launches are the JSON line's ``launches_train``;
13. scale-out and the host runtime, on Wav2Vec2-base at full width
   with the kernel impls, the two clips, 4 draws each ("scale" lines): the
   native batch WER counts of 3,000 seeded pairs against the plain DP, and
   the base path's phi written by the native writer and by its pool (the
   same bytes; np.save's length and data, the header's 2-D shape spelled
   "(r, c, )") with the walls of a synchronous write and of a submit; a
   mesh of one NCCL rank through run_shap_pipeline at sample_batch 1 (draws
   sharded) and 2 (samples sharded), phi bit-equal to the unmeshed run and
   the same launches (the JSON line's ``launches_scale``); two processes on
   the one card over gloo: draw-sharded phi within 1e-6 of max|phi| of the
   single rank's, sample-sharded phi equal, and at model_parallel=2 the
   base's and the rel-pos-large conformer's logits within 1e-5 of
   max|logits| of unsharded and one draw's phi within 1e-4 of max|phi|;
   conv_impl "gemm" and "hybrid" against "pallas" on one draw (float32
   within 1e-4 of max|phi|, bf16 by phase 7's rule) with the six
   feature-encoder backwards per draw of each formulation and of the
   library's conv timed; and run-shap --sample-batch 2 --async-writes then
   sweep, the same store bytes and records as a plain run's;
14. data-parallel training, last, on Wav2Vec2-base at full width with the
   kernel impls and the training phase's batch (8 clips of 2 s; "dp"
   lines): a mesh of one NCCL rank, two ``train`` steps with mesh= against
   two without, in float32 and in bf16, under PyTorch's and cuDNN's
   deterministic algorithms: loss, params and both moments bit-equal, the
   same exact launches (the JSON line's ``launches_dp``, with rank 0's
   below); two processes on the one card over gloo (4 clips each): the
   all-reduced gradient of every trainable leaf within 1e-4 of its max|g|
   (floored as phase 12's gate) of one rank's on the whole batch, the loss
   within rtol 1e-5, params and both moments bit-equal across the ranks
   after two ``train`` steps, ``train_synthetic(mesh=)`` with the same
   summary on both, each run's exact launches; ``asr_shap_torch.dryrun.
   dryrun_multichip(2, device="cuda")``; the wall per step with and without
   the mesh and the all-reduce alone ("timing dp": one card, so no
   scale-out speed-up);
15. expected gradients' draw chunks, last ("chunk" lines), at 48,000
   samples, full width, seed 0, the kernel impls, 8 explicit draws: K1 at
   596 cotangent rows (4 draws x 149; xbar past 2^31 elements) against
   its plain version in float32 and bf16; then base float32, base bf16
   and the rel-pos-large conformer float32 at draw_chunk 1, 2, 4 (all 149
   rows per backward) and 8 at output_chunk 64, each with remat on and
   off: the exact launches (``expected_launches_eg``), wall per draw,
   device-busy share (one profiled chunk, remat on), peak memory beside
   its prediction, and phi against
   draw_chunk 1's (float32 within 1e-5 of max|phi|; bf16 no further from
   float32's draw_chunk 1 phi than bf16's draw_chunk 1 phi is, x 1.25).
   Its launches are the JSON line's ``launches_chunk``;
16. remat, last ("remat" lines): phi of 2 draws on the base and the
   conformer with remat off, "full" and "dots" (within 1e-6 of max|phi|,
   bit-equality said), wall per draw and peak each way; one float32
   conformer training step (the training phase's batch) with remat (the
   train module's loss) and without: wall, peak, and each leaf's gradient
   within 1e-6 of its max|g|.

Every expected-gradients run takes ``ExplainerConfig.remat`` (on by
default, as the reference's): each encoder layer runs its forward again in
each backward call, so per draw chunk the flash forward launches once per
layer for the forward plus once per backward call (one per
``output_chunk`` slice), and a training step twice per layer.

Prints one JSON line of per-kernel numbers (the rows of the bf16 K1, the
two bf16 forward and the four bf16 backward kernels also with their
registers and blocks per SM),
then as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import hashlib
import io
import itertools
import json
import multiprocessing
import re
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from asr_shap_torch import cli, native
from asr_shap_torch.audio.invert import mel_to_audio
from asr_shap_torch.audio.mel import log_mel_spectrogram
from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    ConformerConfig,
    ExplainerConfig,
    MeshConfig,
    MetricConfig,
    PipelineConfig,
    TrainConfig,
    Wav2Vec2Config,
    Wav2Vec2ConformerConfig,
)
from asr_shap_torch.core.device import highest_precision, matmul_precision_scope
from asr_shap_torch.core.params_io import load_config, load_params, save_params
from asr_shap_torch.core.prng import generator
from asr_shap_torch.core.store import AttributionStore, key_for
from asr_shap_torch.dryrun import dryrun_multichip
from asr_shap_torch.explain.baselines import zeros_noise_background
from asr_shap_torch.explain.deepshap import (
    deep_shap_values,
    w2v2_conformer_dual_fn,
    wav2vec2_dual_fn,
)
from asr_shap_torch.explain.expected_gradients import (
    expected_gradients,
    expected_phi,
    num_draws,
    sample_draws,
)
from asr_shap_torch.explain.kernel_shap import kernel_shap_attributions, sample_coalitions
from asr_shap_torch.explain.lime import lime_attributions, lime_masks
from asr_shap_torch.kernels import LAUNCHES, build_all, reset_launches
from asr_shap_torch.kernels import _build
from asr_shap_torch.kernels import conv_dgrad as k1
from asr_shap_torch.kernels import flash_attention as fa
from asr_shap_torch.metrics.eta_raw import eta_raw
from asr_shap_torch.metrics.wer import wer, word_edit_counts
from asr_shap_torch.models.conformer import (
    conformer_logits,
    deepshap_rules,
    init_conformer_params,
)
from asr_shap_torch.models.heads import (
    aggregation_head,
    make_batched_fn,
    make_explained_fn,
    model_logits_fn,
)
from asr_shap_torch.models.nemo_ctc import (
    convert_nemo_state_dict,
    init_nemo_ctc_params,
    nemo_conformer_config,
    nemo_ctc_decode,
    nemo_ctc_logits,
)
from asr_shap_torch.models.w2v2_conformer import (
    init_w2v2_conformer_params,
    w2v2_conformer_logits,
)
from asr_shap_torch.models.wav2vec2 import (
    _conv1d,
    cast_params_for_compute,
    feature_lengths,
    init_wav2vec2_params,
    wav2vec2_logits,
)
from asr_shap_torch.ops.attention import rel_shift
from asr_shap_torch.ops.ctc import ctc_loss
from asr_shap_torch.parallel.mesh import data_mean, make_mesh
from asr_shap_torch.parallel.tp import shard_params_tp
from asr_shap_torch.pipeline import compare as compare_mod
from asr_shap_torch.pipeline import train as train_mod
from asr_shap_torch.pipeline import train_synthetic as train_syn_mod
from asr_shap_torch.pipeline.compare import amplified_pair
from asr_shap_torch.pipeline.run_shap import explain_phi, run_shap_pipeline
from asr_shap_torch.pipeline.testset import CHAR_DURATION, synthetic_speech
from asr_shap_torch.pipeline.train_synthetic import synthetic_batches, train_synthetic
from asr_shap_torch.viz.interactive import load_attribution_view
from asr_shap_torch.viz.wav_io import read_wav, write_wav

N_SAMPLES = 48_000
NSAMPLES = 4
SEED = 0
CONFORMER_ARCHIVE = "artifacts/params_synthetic_conformer.npz"
STUDY_ARCHIVE = "artifacts/params_synthetic_study.npz"
STUDY_SAMPLES = 100_000  # the study archive's clips, as its committed studies
# run-shap's test set for the conformer archive, in float32 and in bf16
CONFORMER_CLI_ARGS = ("--num-samples", "1", "--snrs", "5", "--min-length", str(N_SAMPLES),
                      "--max-length", str(N_SAMPLES), "--nsamples", "2")
# the kernels each path must launch, and the TPU kernel each one replaces
BASE_KERNELS = ("conv_dgrad", "flash_fwd", "flash_dq", "flash_dkv")
# the bf16 path's kernels (model dtype="bfloat16"), and their JSON names
BF16_KERNELS = ("conv_dgrad_bf16", "flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16")
CONFORMER_KERNELS = ("conv_dgrad", "flash_fwd_bias", "flash_dq_dbias", "flash_dkv_bias")
# the bf16 conformer's kernels (dtype="bfloat16": K1 and the full-bias flash kernels)
BF16_CONFORMER_KERNELS = ("conv_dgrad_bf16", "flash_fwd_bias_bf16", "flash_dq_dbias_bf16",
                          "flash_dkv_bias_bf16")
BF16_NAMES = dict(zip(BF16_KERNELS + BF16_CONFORMER_KERNELS[1:],
                      ("K1-bf16", "K2-bf16", "K3-bf16", "K4-bf16", "K2f-bf16", "K3b-bf16",
                       "K4f-bf16")))
ROUTES = {
    "conv_dgrad": ("asr_shap_torch/csrc/conv_dgrad.cu", "asr_shap/kernels/conv_dgrad.py:150"),
    "flash_fwd": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:282"),
    "flash_fwd_bias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq_dbias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv_bias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:282"),
    "conv_dgrad_bf16": ("asr_shap_torch/csrc/conv_dgrad_bf16.cu",
                        "asr_shap/kernels/conv_dgrad.py:150"),
    "flash_fwd_bf16": ("asr_shap_torch/csrc/flash_fwd_bf16.cu", "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq_bf16": ("asr_shap_torch/csrc/flash_bwd_bf16.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv_bf16": ("asr_shap_torch/csrc/flash_bwd_bf16.cu", "asr_shap/kernels/flash_attention.py:282"),
    "flash_fwd_bias_bf16": ("asr_shap_torch/csrc/flash_fwd_bf16.cu",
                            "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq_dbias_bf16": ("asr_shap_torch/csrc/flash_bwd_bf16.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv_bias_bf16": ("asr_shap_torch/csrc/flash_bwd_bf16.cu", "asr_shap/kernels/flash_attention.py:282"),
}
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
BF16 = torch.bfloat16
# a bf16 output against its plain version: one bf16 ulp apart at most
# (rtol 2^-7, atol 2^-8 of max|plain|); against float64, at most this many
# times the plain version's error (bf16 outputs) or BF16_F32_OUT_RATIO
# times (the float32 outputs lse and dd, the float32 kernels' rule)
BF16_RTOL, BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -8
BF16_F64_RATIO = 1.25
BF16_F32_OUT_RATIO = 2.0
# the host-clocked times of the flash forward and its yardsticks are one
# mean of 50 calls each (the JSON line's); the least of this many such
# means is logged beside them, as host time varies on a shared host
HOST_REPEATS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_bf16(flops: float, nbytes: float):
    """The least time of a function on bf16 inputs: its operations at the
    card's dense bf16 peak, or its bytes."""
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations (bf16)") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_3xtf32(flops: float, nbytes: float):
    """The bound of a GEMM run in 3xTF32: three TF32 products per float32
    product at the tensor cores' TF32 peak, or the bytes."""
    t_ops, t_bytes = 3 * flops / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations (3xTF32)") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int, warmup: int = 2, repeats: int = 1) -> float:
    """Mean time per call of ``iters`` calls between two CUDA events; with
    ``repeats`` > 1 the least of that many such means (for calls whose time
    is the host's, which varies from run to run on a shared host)."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def device_ms(fn, kernel: str, iters: int = 50, tries: int = 3) -> float:
    """Device time per launch of the kernels whose name holds ``kernel``,
    from torch.profiler over ``iters`` calls of ``fn`` after a warm-up.

    The profiler may drop some or all of its window's device records. A try
    that saw under half the launches is profiled again; after ``tries`` the
    time is the mean over the launches of the try that saw most, and where no
    try saw any, the time per call of ``fn`` between two CUDA events (which
    holds ``fn``'s other work on the card too, if it has any)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = (0, 0.0)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
                total += e.self_device_time_total
                count += e.count
        # the profiler may drop some of its window's device records:
        # average what it saw, and profile again if it saw under half
        if count >= iters // 2:
            return total / count / 1e3
        most = max(most, (count, total))
        log(f"profiler saw {count} launches of {kernel} of {iters}; profiling again")
    if most[0]:
        log(f"profiler saw at most {most[0]} launches of {kernel} of {iters} in {tries} "
            f"tries; device time is their mean")
        return most[1] / most[0] / 1e3
    log(f"profiler saw no launch of {kernel} in {tries} tries; timed by CUDA events instead")
    return time_ms(fn, iters)


def device_ms_per_call(fn, iters: int = 50, tries: int = 3, host_ops: bool = True) -> float:
    """Device time per call of ``fn`` (all its kernels), from torch.profiler
    over ``iters`` calls after a warm-up; profiled again when the profiler
    recorded no device time (it may drop its window's device records, as
    ``device_ms`` notes), and timed by CUDA events where no try recorded
    any. ``host_ops=False`` records the device alone (a call of thousands
    of small ops profiles in a fraction of the time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    for _ in range(tries):
        with profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / iters / 1e3
        log("profiler recorded no device time; profiling again")
    log(f"profiler recorded no device time in {tries} tries; timed by CUDA events instead")
    return time_ms(fn, iters)


def compare_bf16(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
                 rtol: float, why: str) -> float:
    """``compare`` for one output of a kernel that may run in bf16: a bf16
    output is held to one bf16 ulp of ``want`` (BF16_RTOL, BF16_ATOL_REL of
    max|want|), a float32 one (lse, dd) to ``atol``, ``rtol``."""
    if got.dtype == BF16:
        scale = float(want.abs().max())
        hi = torch.promote_types(want.dtype, torch.float32)
        return compare(name, got.to(hi), want.to(hi), BF16_ATOL_REL * scale, BF16_RTOL,
                       "bf16 output: one bf16 ulp (float32 sums in another order may "
                       "round to the neighbouring bf16)")
    return compare(name, got, want, atol, rtol, why)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, why: str) -> float:
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_abs = float(err.max())
    log(f"check {name}: max_abs_err={max_abs:.3e} (atol {atol:g}, rtol {rtol:g}: {why})")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(worst <= atol, f"{name}: exceeds tolerance")
    return max_abs


# ---------------------------------------------------------------- shapes

def k1_main_shapes(cfg: Wav2Vec2Config, rows: int, n_samples: int = N_SAMPLES):
    """(K, s, C_in, C_out, T_in, T_out) of each eligible feature-encoder
    layer at ``n_samples``, for ``rows`` cotangent rows."""
    out, t = [], n_samples
    c_in = 1
    for c, k, s in zip(cfg.conv_dim, cfg.conv_kernel, cfg.conv_stride):
        t_out = (t - k) // s + 1
        if k1.eligible(c_in, c, s, 1, 0):
            out.append((k, s, c_in, c, t, t_out))
        t, c_in = t_out, c
    return out


def k1_inputs(gen, b, k, c_in, c_out, t_out):
    ybar = torch.randn((b, t_out, c_out), generator=gen, device="cuda")
    w = torch.randn((k, c_in, c_out), generator=gen, device="cuda") * (2.0 / (k * c_in)) ** 0.5
    return ybar, w


def k1_cost(b, k, s, c_in, c_out, t_in, t_out):
    flops = 2.0 * b * t_out * k * c_in * c_out
    nbytes = 4.0 * (b * t_out * c_out + k * c_in * c_out + b * t_in * c_in)
    return flops, nbytes


def flash_inputs(gen, b, h, t, d, v_rows, masked):
    q, k, v = (torch.randn((b * h, t, d), generator=gen, device="cuda") for _ in range(3))
    bias = None
    if masked:
        bias = torch.zeros((b, t), device="cuda")
        bias[:, t - 29:] = -1e9
    g = torch.randn((v_rows * b * h, t, d), generator=gen, device="cuda")
    return q, k, v, bias, g


def rel_pos_bias(gen, q, masked):
    """A [BH, T, T] float32 full bias shaped like the conformer's: q (in
    float32) . random position projections over 2T-1 relative positions,
    rel-shifted and scaled by D^-1/2; ``masked`` adds -1e9 on the last 29
    keys."""
    bh, t, d = q.shape
    p_proj = torch.randn((2 * t - 1, bh, d), generator=gen, device="cuda")
    bias = rel_shift(torch.einsum("bhtd,rhd->bhtr", q[None].float(), p_proj))[0] * d ** -0.5
    if masked:
        bias[..., t - 29:] = -1e9
    return bias.contiguous()


def flash_costs(bh, n, t, d):
    """(operations, bytes) of one launch of each flash kernel with a full
    bias: each input read once, each output written once, the scores
    counted once per residual row (the least the functions need)."""
    return {
        "flash_fwd_bias": (4.0 * bh * t * t * d,
                           4.0 * (4 * bh * t * d + bh * t + bh * t * t)),
        "flash_dq_dbias": (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                           4.0 * (2 * n * t * d + n * t + n * t * t
                                  + 4 * bh * t * d + bh * t + bh * t * t)),
        "flash_dkv_bias": (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
                           4.0 * (3 * n * t * d + n * t + 3 * bh * t * d
                                  + bh * t + bh * t * t)),
    }


# ---------------------------------------------------------------- phases

def phase_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    paths = build_all()
    log(f"build: {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            if any(key in line for key in ("Used", "spill", "entry function", "wgmma")):
                log(f"ptxas {name}: {line.strip()}")
    fields = check_bf16_backward_build(paths["flash_bwd_bf16"])
    fields.update(check_bf16_forward_build(paths["flash_fwd_bf16"]))
    fields["conv_dgrad_bf16"] = check_conv_dgrad_bf16_build(paths["conv_dgrad_bf16"])
    return smi, fields


def sass_functions(lib: Path) -> dict:
    """Each kernel's SASS in ``lib`` (``cuobjdump -sass``, from the toolkit
    that built it), by its mangled name."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"{cuobjdump} not found: the SASS check cannot run")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return {body.split(maxsplit=1)[0]: body for body in re.split(r"Function : ", sass)[1:]}


def check_conv_dgrad_bf16_build(lib: Path) -> dict:
    """The bf16 K1 as built: its registers, spilled bytes, shared memory per
    block and blocks per SM (``conv_dgrad_bf16_info``), and its SASS: bf16
    warpgroup products with float32 sums (HGMMA ... F32.BF16) and no other
    tensor-core product (no HGMMA of another type, no HMMA). Returns its
    registers, blocks per SM and shared bytes, the JSON line's fields."""
    info_fn = _build.c_function("conv_dgrad_bf16", "conv_dgrad_bf16_info", (ctypes.c_void_p,))
    info = (ctypes.c_int * 4)()
    check(info_fn(ctypes.addressof(info)) == 0, "K1-bf16: info failed")
    regs, spilled, smem, per_sm = info
    log(f"kernel K1-bf16: {regs} registers, {spilled} bytes spilled, {smem} bytes of shared "
        f"memory per block, {per_sm} blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    bodies = [body for fn, body in sass_functions(lib).items() if "dgrad_bf16_wgmma_kernel" in fn]
    check(len(bodies) == 1, f"sass: {len(bodies)} bf16 K1 kernels in {lib}, 1 expected")
    lines = bodies[0].splitlines()
    hgmma = [line for line in lines if "HGMMA" in line]
    bf16 = sum(".F32.BF16" in line for line in hgmma)
    hmma = sum("HMMA" in line for line in lines)
    log(f"sass dgrad_bf16_wgmma_kernel: {bf16} HGMMA ... F32.BF16 of {len(hgmma)} HGMMA, "
        f"{hmma} HMMA")
    for line in hgmma:
        if ".F32.BF16" not in line:
            log(f"sass dgrad_bf16_wgmma_kernel, not bf16: {line.strip()}")
    check(bf16 > 0 and bf16 == len(hgmma) and hmma == 0,
          "sass dgrad_bf16_wgmma_kernel: not only bf16 warpgroup products")
    return {"registers": regs, "blocks_per_sm": per_sm, "shared_bytes": smem}


# the bf16 backward kernels in flash_bwd_bf16_info's order: counter, and the
# shared memory per block of the float32 template each one replaced, KB
BF16_BWD_KERNELS = (("flash_dq_bf16", 224), ("flash_dq_dbias_bf16", 224),
                    ("flash_dkv_bf16", 173), ("flash_dkv_bias_bf16", 173))


def check_bf16_backward_build(lib: Path) -> dict:
    """The bf16 backward kernels as built, at D = 64 and 32: each one's
    registers, spilled bytes, shared memory per block and blocks per SM
    (``flash_bwd_bf16_info``), its shared memory under half the float32
    template's; and their SASS: every instantiation runs bf16 m16n8k16
    tensor-core products only (``check_bf16_mma_only``), no TF32 product.
    Returns each kernel's registers and blocks per SM at D = 64, the JSON
    line's fields."""
    info_fn = _build.c_function("flash_bwd_bf16", "flash_bwd_bf16_info",
                                (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    fields = {}
    for d in (64, 32):
        for index, (counter, f32_kb) in enumerate(BF16_BWD_KERNELS):
            name = BF16_NAMES[counter]
            info = (ctypes.c_int * 4)()
            check(info_fn(index, d, ctypes.addressof(info)) == 0, f"{name}: info failed")
            regs, spilled, smem, per_sm = info
            if d == 64:
                fields[counter] = {"registers": regs, "blocks_per_sm": per_sm}
            log(f"kernel {name} D={d}: {regs} registers, {spilled} bytes spilled, {smem} bytes "
                f"of shared memory per block (float32 template {f32_kb} KB), {per_sm} blocks "
                "per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
            check(smem < f32_kb * 1024 / 2, f"{name} D={d}: {smem} bytes of shared memory, not "
                  f"under half the float32 template's {f32_kb} KB")
    check_bf16_mma_only(lib, ("flash_dq_bf16_kernel", "flash_dkv_bf16_kernel"),
                        2 * len(BF16_BWD_KERNELS))
    return fields


def check_bf16_mma_only(lib: Path, kernels, expected: int) -> None:
    """The SASS (``cuobjdump -sass`` of ``lib``, from the toolkit that built
    it) of every function whose name holds one of ``kernels``: each runs
    bf16 m16n8k16 tensor-core products (HMMA.16816.F32.BF16) and no other
    HMMA, so no TF32 product; ``expected`` such functions."""
    seen = 0
    for fn, body in sass_functions(lib).items():
        if not any(kernel in fn for kernel in kernels):
            continue
        seen += 1
        hmma = [line for line in body.splitlines() if "HMMA" in line]
        bf16 = sum("HMMA.16816.F32.BF16" in line for line in hmma)
        log(f"sass {fn}: {bf16} HMMA.16816.F32.BF16 of {len(hmma)} HMMA")
        check(bf16 > 0 and bf16 == len(hmma),
              f"sass {fn}: not only bf16 m16n8k16 tensor-core products")
    check(seen == expected, f"sass: {seen} functions of {kernels} in {lib}, {expected} expected")


# the bf16 forward kernels (flash_fwd_bf16_info's `full` 0 and 1): counter,
# and the query rows per block of the path's launches (fwd_block_rows: 16
# for BH = 12, 32 for BH = 16)
BF16_FWD_KERNELS = (("flash_fwd_bf16", 16), ("flash_fwd_bias_bf16", 32))


def check_bf16_forward_build(lib: Path) -> dict:
    """The bf16 flash forward as built (``csrc/flash_fwd_bf16.cu``), K2 with a
    key mask and K2f, at D = 64 and 32, 16 and 32 query rows per block and
    T = 149: each one's registers, spilled bytes, shared memory per block and
    blocks per SM (``flash_fwd_bf16_info``); and its SASS: bf16 m16n8k16
    tensor-core products only (``check_bf16_mma_only``), no TF32 product.
    Returns each kernel's registers, blocks per SM and shared bytes at D = 64
    and its path's rows per block, the JSON line's fields."""
    info_fn = _build.c_function("flash_fwd_bf16", "flash_fwd_bf16_info",
                                (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
    fields = {}
    for d in (64, 32):
        for full, (counter, path_rows) in enumerate(BF16_FWD_KERNELS):
            for rows in fa.FWD_ROWS:
                info = (ctypes.c_int * 4)()
                check(info_fn(full, d, rows, 149, ctypes.addressof(info)) == 0,
                      f"{BF16_NAMES[counter]}: info failed")
                regs, spilled, smem, per_sm = info
                if d == 64 and rows == path_rows:
                    fields[counter] = {"registers": regs, "blocks_per_sm": per_sm,
                                       "shared_bytes": smem}
                log(f"kernel {BF16_NAMES[counter]} D={d} rows/block={rows} T=149: {regs} "
                    f"registers, {spilled} bytes spilled, {smem} bytes of shared memory per "
                    f"block, {per_sm} blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    check_bf16_mma_only(lib, ("flash_fwd_bf16_kernel",), 4)
    return fields


def k1_float64_check(gen, b, k, s, ci, co, ti, to, dtype=torch.float32) -> dict:
    """K1 and its plain version against the plain version in float64, at
    one main-path shape. float32: the accuracy of 3xTF32 on the card's
    tensor cores beside float32's; each is held to K1's tolerance, and K1
    to at most twice the plain version's error. bf16: the same bf16 inputs
    in float64, not rounded; K1 to at most BF16_F64_RATIO times the plain
    version's error."""
    ybar, w = (x.to(dtype) for x in k1_inputs(gen, b, k, ci, co, to))
    want = k1.conv1d_dgrad_plain(ybar.double(), w.double(), s, ti)
    errs = {}
    label = "float32" if dtype == torch.float32 else "bf16"
    for key, got in (("kernel", k1.conv1d_dgrad(ybar, w, s, ti)),
                     ("plain", k1.conv1d_dgrad_plain(ybar, w, s, ti))):
        errs[key] = compare_bf16(f"{k1_name(dtype)} B={b} K={k} s={s} T_out={to}: {key} "
                                 f"({label}) vs float64",
                                 got if dtype == BF16 else got.double(), want, 5e-4, 1e-4,
                                 "K1's tolerance, against the exact sum")
        del got
    ratio, what = (2, "3xTF32") if dtype == torch.float32 else (BF16_F64_RATIO, "bf16")
    log(f"{k1_name(dtype)} vs float64: kernel {errs['kernel']:.3e}, {label} plain "
        f"{errs['plain']:.3e} (ratio {errs['kernel'] / errs['plain']:.2f}, limit {ratio})")
    # float32, as the CPU test holds the 3xTF32 emulation: at most 2x
    # float32's error
    check(errs["kernel"] <= ratio * errs["plain"],
          f"{k1_name(dtype)}: {what} error over {ratio}x the plain version's against float64")
    return errs


# the bf16 K1's edge shapes: clips, output rows, (taps, stride) and
# (C_in, C_out); each at T_in = the last row a tap reaches, and s - 1 rows
# past it (rows no tap reaches, zero)
K1_EDGES = ((1, 3), (1, 2, 7, 300), ((3, 2), (2, 2), (5, 3)),
            ((128, 128), (256, 512), (512, 384)))


def check_k1_bf16_edges(gen):
    """The bf16 K1 at every edge shape of K1_EDGES (tiles that end ragged
    inside a clip, one-row clips, a stride of 3 with a phase group of one,
    rows past the taps' reach): each output within one bf16 ulp of the plain
    version, and against float64 on the same bf16 inputs at most
    BF16_F64_RATIO times the plain version's error. Logs one line per
    (B, K, s, C) over its T_out and T_in; returns the largest error against
    the plain version and the largest ratio to its float64 error."""
    worst = worst_ratio = 0.0
    for b, (k, s), (ci, co) in itertools.product(K1_EDGES[0], K1_EDGES[2], K1_EDGES[3]):
        group_err = group_ratio = 0.0
        for to, extra in itertools.product(K1_EDGES[1], sorted({0, s - 1})):
            ti = (to - 1) * s + k + extra
            ybar, w = (x.to(BF16) for x in k1_inputs(gen, b, k, ci, co, to))
            got = k1.conv1d_dgrad(ybar, w, s, ti).float()
            plain = k1.conv1d_dgrad_plain(ybar, w, s, ti).float()
            want = k1.conv1d_dgrad_plain(ybar.double(), w.double(), s, ti)
            label = f"conv_dgrad_bf16 edge B={b} K={k} s={s} C={ci}x{co} T_out={to} T_in={ti}"
            err = (got - plain).abs()
            excess = float((err - BF16_RTOL * plain.abs()).max())
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            check(excess <= BF16_ATOL_REL * float(plain.abs().max()),
                  f"{label}: over one bf16 ulp from the plain version")
            e_k = float((got.double() - want).abs().max())
            e_p = float((plain.double() - want).abs().max())
            check(e_k <= BF16_F64_RATIO * e_p, f"{label}: error against float64 {e_k:.3e} over "
                  f"{BF16_F64_RATIO}x the plain version's {e_p:.3e}")
            group_err = max(group_err, float(err.max()))
            group_ratio = max(group_ratio, e_k / e_p if e_p else 0.0)
        log(f"check conv_dgrad_bf16 edges B={b} K={k} s={s} C={ci}x{co} T_out "
            f"{K1_EDGES[1]}: max_abs_err={group_err:.3e} (one bf16 ulp: rtol {BF16_RTOL:g}, "
            f"atol {BF16_ATOL_REL:g} x max|plain|); vs float64 ratio to the plain version "
            f"{group_ratio:.3f} (limit {BF16_F64_RATIO})")
        worst, worst_ratio = max(worst, group_err), max(worst_ratio, group_ratio)
    return worst, worst_ratio


def k1_name(dtype) -> str:
    return "conv_dgrad_bf16" if dtype == BF16 else "conv_dgrad"


def check_fwd_lengths(gen, h: int, d: int, full: bool, dtype=torch.float32) -> float:
    """K2 (``full``: K2f) at both block heights against its plain version at
    T = 1 (one key), T = 100 (one partial chunk; some warps hold no key),
    T = 500 (several chunks of keys, so the online rescale runs) and
    T = 1,499 (30 s of audio: eight chunks of the float32 kernel, ten of the
    bf16 one), with the first 200 keys and the last 29 masked to -1e9 (for
    the full bias, on every other query row): a row's first chunk is all
    masked, so its rescale factor is 0. In bf16, q, k, v are rounded to bf16
    and o is held to one bf16 ulp."""
    err = 0.0
    name = ("flash_fwd_bias" if full else "flash_fwd") + ("_bf16" if dtype == BF16 else "")
    for t in (1, 100, 500, 1499):
        q, k, v, bias, _ = flash_inputs(gen, 1, h, t, d, 1, not full)
        q, k, v = (x.to(dtype) for x in (q, k, v))
        if full:
            bias = rel_pos_bias(gen, q, True)
            bias[:, ::2, :200] = -1e9
        else:
            bias[:, :200] = -1e9
        want = fa.flash_fwd_plain(q, k, v, bias, h)
        for rows in fa.FWD_ROWS:
            fa._check(q, k, v, bias, h)
            got = fa._fwd_launch(q, k, v, bias, h, rows)
            for part, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                err = max(err, compare_bf16(
                    f"{name} {part} BH={h} T={t} rows/block={rows} masked", x, y, 2e-5, 2e-4,
                    f"float32 softmax over {t} keys, another summation order"))
    return err


def check_fwd_sweep_shapes(gen, dtype=torch.float32) -> float:
    """K2 at the sweep's batched forward: 8 clips of one length, no bias,
    T = 149 (48,000 samples) and 312 (100,000), with the base model's 12
    heads of 64 and the study archive's 3 heads of 32; both block heights.
    In bf16, q, k, v are rounded to bf16 and o is held to one bf16 ulp."""
    err = 0.0
    name = "flash_fwd_bf16" if dtype == BF16 else "flash_fwd"
    for h, d in ((12, 64), (3, 32)):
        for t in (149, 312):
            q, k, v, _, _ = flash_inputs(gen, 8, h, t, d, 1, False)
            q, k, v = (x.to(dtype) for x in (q, k, v))
            want = fa.flash_fwd_plain(q, k, v, None, h)
            fa._check(q, k, v, None, h)
            for rows in fa.FWD_ROWS:
                got = fa._fwd_launch(q, k, v, None, h, rows)
                for part, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                    err = max(err, compare_bf16(
                        f"{name} {part} B=8 H={h} T={t} D={d} rows/block={rows} (sweep)",
                        x, y, 2e-5, 2e-4, f"float32 softmax over {t} keys, another "
                        "summation order"))
    return err


def mask_lengths(b: int, t: int, lengths) -> torch.Tensor:
    """A [B, T] key mask: clip i keeps its first lengths[i] keys, -1e9 after."""
    bias = torch.zeros((b, t), device="cuda")
    for i, n in enumerate(lengths):
        bias[i, n:] = -1e9
    return bias


def full_bias_lengths(gen, q, h: int, lengths) -> torch.Tensor:
    """A rel-pos-like [BH, T, T] bias (``rel_pos_bias``) whose clip i (heads
    i*h to (i+1)*h) has every key from lengths[i] on at -1e9."""
    bias = rel_pos_bias(gen, q, False)
    for i, n in enumerate(lengths):
        bias[i * h:(i + 1) * h, :, n:] = -1e9
    return bias


def bwd_kernel_names(full: bool, dtype=torch.float32):
    """The counters (and JSON names) of the dq and dk/dv kernels: K3b and
    K4f for a full bias, else K3 and K4 (in bf16, their bf16 variants)."""
    names = ("flash_dq_dbias", "flash_dkv_bias") if full else ("flash_dq", "flash_dkv")
    return tuple(f"{n}_bf16" for n in names) if dtype == BF16 else names


def check_bwd_shapes(gen, h: int, full: bool = False, dtype=torch.float32) -> dict:
    """K3 and K4 (``full``: K3b and K4f, with a rel-pos-like bias) against
    their plain versions where the grouped kernels can break, each case
    unmasked and masked: one cotangent row per residual row (N = BH); 37
    rows per residual row (the last group of 8 warps part empty); five
    clips with a mask length each; 100 keys (a partial chunk) and 500 keys
    with the last 200 masked (several chunks); and D = 32. With a full bias
    d(bias) is compared too, and must be exactly 0 on masked keys. In bf16
    (q, k, v, g rounded to bf16; the bias float32) also D = 32 at T = 312,
    the study archive's shape, and T = 160, and each bf16 output to one bf16
    ulp."""
    why = "float32 backward sums over T keys, another summation order"
    dq_name, dkv_name = bwd_kernel_names(full, dtype)
    errs = {dq_name: 0.0, dkv_name: 0.0}
    # (clips B, keys T, head dim D, cotangent rows per residual row, mask lengths)
    cases = [(1, 149, 64, 1, [120]), (1, 149, 64, 37, [120]),
             (5, 149, 64, 8, [149, 131, 100, 77, 16]), (1, 100, 64, 8, [71]),
             (1, 500, 64, 8, [300]), (1, 149, 32, 8, [120])]
    if dtype == BF16:  # T = 160: K3b's last d(bias) tile of 32 keys spans 9 units of a row
        cases += [(1, 312, 32, 8, [290]), (1, 160, 64, 8, [131])]
    for b, t, d, v_rows, lengths in cases:
        for masked in (False, True):
            q, k, v, _, g = (None if x is None else x.to(dtype)
                             for x in flash_inputs(gen, b, h, t, d, v_rows, False))
            if full:
                bias = full_bias_lengths(gen, q, h, lengths if masked else [])
            else:
                bias = mask_lengths(b, t, lengths) if masked else None
            o, lse = fa.flash_fwd_plain(q, k, v, bias, h)
            label = f"B={b} T={t} D={d} N={g.shape[0]} ({v_rows} per residual row) mask={masked}"
            dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, h)
            dq_p, dd_p, dbias_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
            errs[dq_name] = max(errs[dq_name],
                                compare_bf16(f"{dq_name} dq {label}", dq, dq_p, 5e-5, 5e-4, why),
                                compare_bf16(f"{dq_name} dd {label}", dd, dd_p, 5e-5, 5e-4, why))
            if full:
                errs[dq_name] = max(errs[dq_name], compare(
                    f"{dq_name} dbias {label}", dbias, dbias_p, 5e-5, 5e-4, why))
                if masked:
                    planes = dbias.reshape(v_rows, b, h, t, t)
                    check(all(bool((planes[:, i, :, :, n:] == 0).all())
                              for i, n in enumerate(lengths)),
                          f"{dq_name} {label}: d(bias) not 0 on masked keys")
            del dq, dd, dbias, dq_p, dbias_p
            dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
            dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
            errs[dkv_name] = max(errs[dkv_name],
                                 compare_bf16(f"{dkv_name} dk {label}", dk, dk_p, 5e-5, 5e-4, why),
                                 compare_bf16(f"{dkv_name} dv {label}", dv, dv_p, 5e-5, 5e-4, why))
            del q, k, v, g, bias, o, lse, dd_p, dk, dv, dk_p, dv_p
    return errs


def bwd_float64_check(gen, h: int, d: int, t: int, rows: int, full: bool = False,
                      dtype=torch.float32) -> dict:
    """K3 and K4 (``full``: K3b and K4f, with a rel-pos-like bias) and their
    float32 plain versions against the plain versions in float64, at the
    path's shape: the accuracy of 3xTF32 on the card's tensor cores beside
    float32's. Each is held to the backward's tolerance, and dq, dk, dv
    (and d(bias)) each to at most twice the plain version's error. The
    float32 runs take o, lse and dd from the float64 runs, rounded to
    float32. In bf16: q, k, v, g and o rounded to bf16, and the float64
    runs on those values (o's rounding moves dd, and so d(bias), by far more
    than the float32 tolerance); dq, dk, dv to at most BF16_F64_RATIO times
    the plain version's error, d(bias) (a float32 output) to at most
    BF16_F32_OUT_RATIO times."""
    q, k, v, _, g = (None if x is None else x.to(dtype)
                     for x in flash_inputs(gen, 1, h, t, d, rows, False))
    bias = rel_pos_bias(gen, q, False) if full else None
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    b64 = None if bias is None else bias.double()
    o64, lse64 = fa.flash_fwd_plain(q64, k64, v64, b64, h)
    if dtype == BF16:
        o64 = o64.to(dtype).double()
    dq64, dd64, db64 = fa.flash_dq_plain(q64, k64, v64, o64, lse64, g64, b64, h)
    dk64, dv64 = fa.flash_dkv_plain(q64, k64, v64, lse64, g64, dd64, b64, h)
    o, lse, dd = o64.to(dtype), lse64.float(), dd64.float()
    runs = {"kernel": (fa.flash_dq, fa.flash_dkv),
            "plain": (fa.flash_dq_plain, fa.flash_dkv_plain)}
    why = "the backward's tolerance, against the exact sum"
    label = ("flash backward" + (" bf16" if dtype == BF16 else "")
             + (", full bias," if full else ""))
    names = ("dq", "dk", "dv") + (("dbias",) if full else ())
    ratios = {name: 2 if dtype != BF16 else BF16_F32_OUT_RATIO if name == "dbias"
              else BF16_F64_RATIO for name in names}
    errs = {}
    for key, (dq_fn, dkv_fn) in runs.items():
        dq, _, dbias = dq_fn(q, k, v, o, lse, g, bias, h)
        dk, dv = dkv_fn(q, k, v, lse, g, dd, bias, h)
        outs = {"dq": (dq, dq64), "dk": (dk, dk64), "dv": (dv, dv64), "dbias": (dbias, db64)}
        for name in names:
            got, want = outs[name]
            errs[key, name] = compare_bf16(
                f"{label} {name} N={g.shape[0]} T={t}: {key} vs float64",
                got if got.dtype == BF16 else got.double(), want, 5e-5, 5e-4, why)
        del dq, dk, dv, dbias, outs
    for name in names:
        kern, plain, ratio = errs["kernel", name], errs["plain", name], ratios[name]
        log(f"{label} {name} vs float64: kernel {kern:.3e}, plain "
            f"{plain:.3e} (ratio {kern / plain:.2f}, limit {ratio})")
        check(kern <= ratio * plain, f"{label} {name}: error over {ratio}x the plain "
              "version's against float64")
    # each JSON row takes the largest error over its kernel's outputs
    dq_name, dkv_name = bwd_kernel_names(full, dtype)
    per_kernel = {dq_name: ("dq",) + names[3:], dkv_name: ("dk", "dv")}
    return {kname: {"err_vs_float64": max(errs["kernel", x] for x in kouts),
                    "plain_err_vs_float64": max(errs["plain", x] for x in kouts)}
            for kname, kouts in per_kernel.items()}


def phase_checks(cfg: Wav2Vec2Config):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    rows = cfg.frames_for_samples(N_SAMPLES)  # 149 cotangent rows per draw
    why = ("3xTF32 products summed in float32 over up to 1,024 terms against "
           "float32 FMAs, another summation order")
    k_err = k_err_scaled = 0.0
    shapes = k1_main_shapes(cfg, rows)
    # every main-path layer shape; the first again with ybar at 1e3 scale,
    # so that the lo parts of the 3xTF32 split carry weight
    cases = [(rows, k, s, ci, co, ti, to, 1.0) for (k, s, ci, co, ti, to) in shapes]
    cases += [(rows,) + shapes[0] + (1e3,),
              (5, 3, 2, 512, 512, 1000, 499, 1.0),    # ragged rows, a trailing zero row
              (4, 5, 3, 256, 128, 802, 266, 1.0)]     # non-dividing K/s, C_in != C_out
    for b, k, s, ci, co, ti, to, scale in cases:
        ybar, w = k1_inputs(gen, b, k, ci, co, to)
        ybar *= scale
        got = k1.conv1d_dgrad(ybar, w, s, ti)
        want = k1.conv1d_dgrad_plain(ybar, w, s, ti)
        err = compare(f"conv_dgrad B={b} K={k} s={s} C={ci}x{co} T_out={to} "
                      f"ybar scale {scale:g}", got, want, 5e-4 * scale, 1e-4,
                      why + ("" if scale == 1 else "; atol scaled with ybar"))
        if scale == 1:
            k_err = max(k_err, err)
        k_err_scaled = max(k_err_scaled, err / scale)
        del ybar, w, got, want
    errs["conv_dgrad"] = k_err
    f64 = k1_float64_check(gen, rows, *shapes[0])
    # the JSON line's extra fields for K1: the largest error over ybar's
    # scale (the 1e3 case's included), and both float32 errors vs float64
    extra = {"conv_dgrad": {"max_abs_err_over_scale": k_err_scaled,
                            "err_vs_float64": f64["kernel"],
                            "plain_err_vs_float64": f64["plain"]}}

    h, d, t = cfg.num_attention_heads, cfg.head_dim, rows
    for key in ("flash_fwd", "flash_dq", "flash_dkv"):
        errs[key] = 0.0
    errs["flash_fwd"] = check_fwd_lengths(gen, h, d, False)
    for masked in (False, True):
        for b in (1, 5):
            q, k, v, bias, _ = flash_inputs(gen, b, h, t, d, 1, masked)
            got, want = fa.flash_fwd(q, k, v, bias, h), fa.flash_fwd_plain(q, k, v, bias, h)
            for name, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                errs["flash_fwd"] = max(errs["flash_fwd"], compare(
                    f"flash_fwd {name} BH={b * h} T={t} mask={masked}", x, y, 2e-5, 2e-4,
                    "float32 softmax over 149 keys, another summation order"))
        q, k, v, bias, g = flash_inputs(gen, 1, h, t, d, rows, masked)
        o, lse = fa.flash_fwd_plain(q, k, v, bias, h)
        dq, dd, _ = fa.flash_dq(q, k, v, o, lse, g, bias, h)
        dq_p, dd_p, _ = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
        why_b = "float32 backward sums over 149 keys, another summation order"
        errs["flash_dq"] = max(errs["flash_dq"],
                               compare(f"flash_dq N={g.shape[0]} mask={masked}", dq, dq_p, 5e-5, 5e-4, why_b),
                               compare(f"flash_dq dd mask={masked}", dd, dd_p, 5e-5, 5e-4, why_b))
        dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
        errs["flash_dkv"] = max(errs["flash_dkv"],
                                compare(f"flash_dkv dk N={g.shape[0]} mask={masked}", dk, dk_p, 5e-5, 5e-4, why_b),
                                compare(f"flash_dkv dv N={g.shape[0]} mask={masked}", dv, dv_p, 5e-5, 5e-4, why_b))
    del q, k, v, bias, g, o, lse, dq, dd, dq_p, dd_p, dk, dv, dk_p, dv_p
    errs["flash_fwd"] = max(errs["flash_fwd"], check_fwd_sweep_shapes(gen))
    for key, err in check_bwd_shapes(gen, h).items():
        errs[key] = max(errs[key], err)
    extra.update(bwd_float64_check(gen, h, d, t, rows))
    return errs, extra


def phase_checks_full_bias(cfg: Wav2Vec2ConformerConfig, dtype=torch.float32):
    """K2f, K3b and K4f against their plain versions at the conformer
    slice's shapes: BH = 16, T = 149, D = 64, N = 149 * 16 = 2,384, with a
    rel-pos-like float32 bias, plain and masked; K2f also at 100 and 500
    keys, K3b and K4f also over ``check_bwd_shapes``'s sweep and against
    float64. In bf16 (q, k, v, g rounded to bf16: the bf16 conformer's
    kernels) each bf16 output is held to one bf16 ulp, the trained
    archive's 3 heads of 32 are checked too, and K2f against float64."""
    bf16 = dtype == BF16
    gen = torch.Generator(device="cuda").manual_seed(SEED + (6 if bf16 else 2))
    rows = cfg.frames_for_samples(N_SAMPLES)
    h, d, t = cfg.num_attention_heads, cfg.head_dim, rows
    fwd_name, dq_name, dkv_name = (BF16_CONFORMER_KERNELS if bf16 else CONFORMER_KERNELS)[1:]
    errs = {fwd_name: check_fwd_lengths(gen, h, d, True, dtype), dq_name: 0.0, dkv_name: 0.0}
    why_f = "float32 softmax over 149 keys, another summation order"
    why_b = "float32 backward sums over 149 keys, another summation order"
    # the slice's heads; in bf16 also the trained archive's
    for hh, dd_ in ((h, d),) + (((3, 32),) if bf16 else ()):
        for masked in (False, True):
            q, k, v, _, g = flash_inputs(gen, 1, hh, t, dd_, rows, False)
            q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
            bias = rel_pos_bias(gen, q, masked)
            got, want = fa.flash_fwd(q, k, v, bias, hh), fa.flash_fwd_plain(q, k, v, bias, hh)
            check(got[0].dtype == dtype and got[1].dtype == torch.float32, f"{fwd_name} dtypes")
            n = g.shape[0]
            label = f"BH={hh} T={t} D={dd_} N={n} masked={masked}"
            for name, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                errs[fwd_name] = max(errs[fwd_name], compare_bf16(
                    f"{fwd_name} {name} {label}", x, y, 2e-5, 2e-4, why_f))
            o, lse = want
            dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, hh)
            dq_p, dd_p, dbias_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, hh)
            check(dq.dtype == dtype and dd.dtype == dbias.dtype == torch.float32,
                  f"{dq_name} dtypes")
            errs[dq_name] = max(
                errs[dq_name],
                compare_bf16(f"{dq_name} dq {label}", dq, dq_p, 5e-5, 5e-4, why_b),
                compare_bf16(f"{dq_name} dd {label}", dd, dd_p, 5e-5, 5e-4, why_b),
                compare(f"{dq_name} dbias [{n}, {t}, {t}] {label}", dbias, dbias_p, 5e-5,
                        5e-4, why_b))
            if masked:
                check(bool((dbias[..., t - 29:] == 0).all()), "dbias: masked keys not 0")
            del dq, dd, dbias, dq_p, dbias_p
            dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, hh)
            dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, hh)
            check(dk.dtype == dv.dtype == dtype, f"{dkv_name} dtypes")
            errs[dkv_name] = max(
                errs[dkv_name],
                compare_bf16(f"{dkv_name} dk {label}", dk, dk_p, 5e-5, 5e-4, why_b),
                compare_bf16(f"{dkv_name} dv {label}", dv, dv_p, 5e-5, 5e-4, why_b))
            del q, k, v, g, bias, got, want, o, lse, dd_p, dk, dv, dk_p, dv_p
    for key, err in check_bwd_shapes(gen, h, full=True, dtype=dtype).items():
        errs[key] = max(errs[key], err)
    extra = bwd_float64_check(gen, h, d, t, rows, full=True, dtype=dtype)
    if bf16:
        extra[fwd_name] = fwd_float64_check_bf16(gen, h, d, t, full=True)
    return errs, extra


def make_test_set():
    rng = np.random.default_rng(SEED)
    t = np.arange(N_SAMPLES) / 16_000
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16_000
    voiced = sum(np.sin(h * phase) / h for h in range(1, 12))
    envelope = np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None) ** 0.5
    clean = (0.1 * voiced * envelope + 0.002 * rng.standard_normal(N_SAMPLES)).astype(np.float32)
    p_noise = np.mean(clean.astype(np.float64) ** 2) / 10 ** (5.0 / 10)
    noise = (rng.standard_normal(N_SAMPLES) * np.sqrt(p_noise)).astype(np.float32)
    text = "THE QUICK BROWN FOX"
    return [
        {"type": "clean", "audio": clean, "noise": np.zeros_like(clean),
         "text": text, "snr": float("inf")},
        {"type": "noisy", "audio": clean + noise, "noise": noise, "text": text,
         "snr": 5.0},
    ]


def phase_pipeline(label: str, cfg: PipelineConfig, params, test_set, expect):
    """Drive one path through run_shap_pipeline; every kernel in ``expect``
    must have launched. Returns the launch counts of the run."""
    store = AttributionStore(cfg.data_dir)
    reset_launches()
    t0 = time.perf_counter()
    results = run_shap_pipeline(params, cfg, test_set, store=store, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"pipeline {label}: {len(results)} samples, method {cfg.explainer.method} "
        f"(nsamples {cfg.explainer.nsamples}) in {wall:.2f} s; "
        f"launches {json.dumps(launches)}")
    t_out = cfg.model.frames_for_samples(N_SAMPLES)
    check(len(results) == len(test_set), "pipeline: missing samples")
    for r, sample in zip(results, test_set):
        phi = r["shap_values"]
        check(phi.shape == (N_SAMPLES, t_out), f"phi shape {phi.shape}")
        check(bool(np.isfinite(phi).all()), "phi not finite")
        check(float(np.abs(phi).max()) > 0, "phi all zero")
        check(phi.dtype == np.float32, f"phi is {phi.dtype}, float32 expected")
        stored = store.load(key_for(r["index"], sample["type"], sample["snr"]))
        check(np.array_equal(stored["shap_values"], phi), "store: phi differs on reload")
        check(np.array_equal(stored["audio"], sample["audio"]), "store: audio differs")
        check(np.array_equal(stored["noise"], sample["noise"]), "store: noise differs")
        check(stored["text"] == sample["text"], "store: text differs")
        clean = sample["audio"] - sample["noise"]
        eta = float(eta_raw(torch.from_numpy(clean), torch.from_numpy(sample["noise"]),
                            torch.from_numpy(phi), MetricConfig(itm_variant="strict")))
        log(f"sample {label} {r['index']} {r['type']} snr={r['snr']}: "
            f"transcript={r['transcription']!r} confidence={r['confidence']:.6f} "
            f"eta_raw_strict={eta:.6f} wer={wer(sample['text'], r['transcription']):.6f} "
            f"wall_s={r['wall_s']:.3f} phi_absmax={float(np.abs(phi).max()):.6e}")
    for name in expect:
        check(launches[name] > 0, f"kernel {name} was not launched on the {label} path")
    return launches


def reference_draw(label: str, cfg: PipelineConfig, params, test_set):
    """phi of one full-width draw through the kernels vs the same draw
    through plain PyTorch on the card."""
    ec = dataclasses.replace(cfg.explainer, nsamples=1)
    x = zero_mean_unit_var(torch.from_numpy(test_set[1]["audio"]).cuda())
    bg = 0.01 * torch.randn((ec.num_background, N_SAMPLES),
                            generator=torch.Generator().manual_seed(1)).cuda()
    draws = (torch.tensor([2]), torch.tensor([0.37]))
    plain_cfg = dataclasses.replace(cfg.model, attention_impl="xla", conv_impl="lax")
    phi_k = expected_phi(make_explained_fn(params, cfg.model, ec), x, bg,
                         config=ec, draws=draws)
    phi_p = expected_phi(make_explained_fn(params, plain_cfg, ec), x, bg,
                         config=ec, draws=draws)
    scale = float(phi_p.abs().max())
    err = compare(f"phi {label} full width, kernels vs plain PyTorch (one draw)", phi_k,
                  phi_p, 2e-3 * scale, 0.0, f"2e-3 of max|phi|: float32 through "
                  f"{cfg.model.num_hidden_layers} layers, another summation order in "
                  f"every product")
    log(f"phi {label}: max_abs_err / max|phi| = {err / scale:.3e} (max|phi| {scale:.6e})")


def phase_reference(cfg: PipelineConfig, params, test_set):
    """The base path: one full-width draw, kernels vs plain PyTorch, and a
    narrow model on the card vs the CPU."""
    reference_draw("base", cfg, params, test_set)
    ec = dataclasses.replace(cfg.explainer, nsamples=1)
    narrow = Wav2Vec2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=128, conv_dim=(128, 128, 128),
                            conv_stride=(5, 2, 2), conv_kernel=(10, 3, 2),
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                            feat_proj_dim=128, attention_impl="pallas", conv_impl="pallas")
    small = init_wav2vec2_params(3, narrow, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(2).standard_normal(1600).astype(np.float32))
    bgs = 0.01 * torch.randn((3, 1600), generator=torch.Generator().manual_seed(4))
    d2 = (torch.tensor([0, 2]), torch.tensor([0.25, 0.8]))
    ec2 = dataclasses.replace(ec, nsamples=2, num_background=3)
    phi_cpu = expected_phi(make_explained_fn(small, narrow, ec2), xs, bgs, config=ec2, draws=d2)
    phi_gpu = expected_phi(make_explained_fn(_to_cuda(small), narrow, ec2), xs.cuda(),
                           bgs.cuda(), config=ec2, draws=d2).cpu()
    compare("phi narrow model (D=32 heads), card vs CPU", phi_gpu, phi_cpu,
            2e-3 * float(phi_cpu.abs().max()), 0.0, "2e-3 of max|phi|: float32, "
            "another summation order on each device")


def phase_reference_conformer(cfg: PipelineConfig, params, test_set, data_dir):
    """The conformer slice: one full-width draw, kernels vs plain PyTorch;
    and the trained archive (hidden 96, 3 heads of 32) switched to the
    kernels, through run_shap_pipeline on the card and on the CPU: phi and
    the greedy transcript."""
    reference_draw("conformer", cfg, params, test_set)
    model = dataclasses.replace(load_config(CONFORMER_ARCHIVE), attention_impl="pallas",
                                conv_impl="pallas")
    check(isinstance(model, Wav2Vec2ConformerConfig), "archive: not a conformer config")
    ec = dataclasses.replace(cfg.explainer, nsamples=2)
    clip = [dict(test_set[1], audio=test_set[1]["audio"][:16_000],
                 noise=test_set[1]["noise"][:16_000])]
    out = {}
    for device in ("cpu", "cuda"):
        pc = PipelineConfig(model=model, explainer=ec, seed=SEED,
                            data_dir=f"{data_dir}/archive_{device}")
        reset_launches()
        out[device] = run_shap_pipeline(load_params(CONFORMER_ARCHIVE, device=device), pc,
                                        clip, device=device)[0]
        if device == "cuda":
            for name in ("flash_fwd_bias", "flash_dq_dbias", "flash_dkv_bias"):
                check(LAUNCHES[name] > 0, f"archive on the card: {name} not launched")
    cpu, gpu = out["cpu"], out["cuda"]
    log(f"archive transcripts: card {gpu['transcription']!r}, CPU {cpu['transcription']!r}; "
        f"confidence card {gpu['confidence']:.7f} CPU {cpu['confidence']:.7f}")
    check(gpu["transcription"] == cpu["transcription"], "archive: transcripts differ")
    phi_cpu = torch.from_numpy(cpu["shap_values"])
    compare("phi conformer archive (D=32 heads), card vs CPU",
            torch.from_numpy(gpu["shap_values"]), phi_cpu,
            2e-3 * float(phi_cpu.abs().max()), 0.0,
            "2e-3 of max|phi|: float32, another summation order on each device")


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def run_cli(label: str, argv):
    """One command of ``python -m asr_shap_torch``, in this process, with the
    launch counts set to 0 just before it and read just after: (its JSON
    lines, its launch counts, its wall in seconds)."""
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c for name, c in LAUNCHES.items() if c}
    lines = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    log(f"cli {label}: {argv[0]} in {wall:.2f} s; launches {json.dumps(launches)}")
    for line in lines:
        log(f"cli {label} {argv[0]}: {json.dumps(line)}")
    return lines, launches, wall


def archive_with_kernels(path: str, out: str, **numerics) -> str:
    """A copy of the archive ``path`` whose embedded config selects the
    kernel impls (and ``numerics``: dtype, matmul_precision), written to
    ``out`` by the port's save_params."""
    cfg = dataclasses.replace(load_config(path), attention_impl="pallas", conv_impl="pallas",
                              **numerics)
    save_params(out, load_params(path, device="cpu"), cfg)
    return out


def path_kernels(mc: Wav2Vec2Config) -> tuple:
    """The (K1, forward, dq, dk/dv) launch counters of a model's path."""
    conformer = isinstance(mc, Wav2Vec2ConformerConfig)
    if mc.dtype == "bfloat16":
        return BF16_CONFORMER_KERNELS if conformer else BF16_KERNELS
    return CONFORMER_KERNELS if conformer else BASE_KERNELS


def cli_run(label: str, archive: str, data_dir: str, args, arch="wav2vec2"):
    """run-shap then sweep on the card; each command's kernels must launch:
    the expected-gradients kernels of the path (by the archive's family and
    dtype) and no other kernel from run-shap, its flash forward and nothing
    else from sweep. Returns the sweep's records and its summary line."""
    model = ["--params", archive, "--arch", arch]
    cfg = load_config(archive)
    kernels = path_kernels(cfg)
    fwd = kernels[1]
    if not k1.eligible(cfg.conv_dim[0], cfg.conv_dim[1], cfg.conv_stride[1], 1, 0):
        kernels = kernels[1:]  # no conv layer K1 takes (narrow conv channels)
    (run,), run_launches, run_wall = run_cli(label, ["run-shap", *model, "--data-dir", data_dir,
                                                     *args])
    for name in kernels:
        check(run_launches.get(name, 0) > 0, f"cli {label}: run-shap did not launch {name}")
    check(set(run_launches) <= set(kernels), f"cli {label}: run-shap launched "
          f"{run_launches}, only {kernels} expected")
    lines, sweep_launches, sweep_wall = run_cli(label, ["sweep", *model, "--data-dir", data_dir])
    *records, summary = lines
    check(set(sweep_launches) == {fwd}, f"cli {label}: sweep launched {sweep_launches}, "
          f"only {fwd} expected")
    check(len(records) == run["computed"], f"cli {label}: sweep has {len(records)} records")
    log(f"cli {label}: run-shap {run_wall:.2f} s ({run_wall / run['computed']:.3f} s per "
        f"sample), sweep {sweep_wall:.2f} s ({sweep_wall / len(records):.3f} s per sample, "
        f"{sweep_launches.get(fwd, 0)} {fwd} launches)")
    return records, summary


def phase_cli(base_archive: str, data_dir: str):
    """The command line on the card: the base archive end to end (run-shap,
    sweep, the same sweep on the CPU, transcribe, metric), the trained study
    archive, and the trained conformer archive (its sweep's records
    returned)."""
    d = f"{data_dir}/cli_base"
    records, _ = cli_run("base", base_archive, d, [
        "--num-samples", "1", "--snrs", "5", "--min-length", str(N_SAMPLES),
        "--max-length", str(N_SAMPLES), "--nsamples", str(NSAMPLES)])
    # the same store through the same port code on the CPU
    cpu_lines, _, cpu_wall = run_cli("base", ["sweep", "--params", base_archive, "--data-dir", d,
                                              "--device", "cpu"])
    log(f"cli base: sweep on the CPU {cpu_wall:.2f} s")
    for g, c in zip(records, cpu_lines[:-1]):
        check(g["hypothesis"] == c["hypothesis"],
              f"cli base: card and CPU hypotheses differ: {g['hypothesis']!r} vs "
              f"{c['hypothesis']!r}")
        check(g["wer"] == c["wer"], "cli base: card and CPU WER differ")
        check(abs(g["eta_raw"] - c["eta_raw"]) <= 1e-6,
              f"cli base: eta_raw card {g['eta_raw']} CPU {c['eta_raw']} (limit 1e-6: the "
              "same phi from the store, another summation order of |phi| over frames)")
    check(len(cpu_lines) == len(records) + 1, "cli base: CPU sweep has other records")
    log("cli base: the card's sweep equals the CPU's (hypotheses, WER; eta_raw within 1e-6)")
    clean = next(r for r in records if r["type"] == "clean")
    noisy = next(r for r in records if r["type"] == "noisy")
    (tr,), tr_launches, _ = run_cli("base", ["transcribe", "--params", base_archive,
                                             f"{d}/audio_sample_{clean['index']}_clean_inf.npy"])
    check(tr["transcript"] == clean["hypothesis"],
          f"cli base: transcribe {tr['transcript']!r} vs the sweep's {clean['hypothesis']!r}")
    check(tr_launches.get("flash_fwd", 0) > 0, "cli base: transcribe did not launch flash_fwd")
    files = {kind: f"{d}/{kind}_sample_{noisy['index']}_noisy_{noisy['snr']}.npy"
             for kind in ("audio", "noise", "shap_values")}
    (metric,), _, _ = run_cli("base", ["metric", "--audio", files["audio"], "--noise",
                                       files["noise"], "--shap", files["shap_values"],
                                       "--itm", "strict"])
    check(abs(metric["eta_raw"] - noisy["eta_raw"]) <= 1e-6,
          f"cli base: metric {metric['eta_raw']} vs the sweep's {noisy['eta_raw']} (limit "
          "1e-6, as the CPU's sweep)")
    log("cli base: transcribe gives the sweep's clean hypothesis, metric its eta_raw")

    study = archive_with_kernels(STUDY_ARCHIVE, f"{data_dir}/study_pallas.npz")
    _, summary = cli_run("study", study, f"{data_dir}/cli_study", [
        "--num-samples", "2", "--snrs", "5", "1", "--min-length", str(STUDY_SAMPLES),
        "--max-length", str(STUDY_SAMPLES), "--nsamples", str(NSAMPLES)])
    for snr, row in summary["per_snr"].items():
        log(f"cli study (information): snr={snr} n={row['n']} mean_wer={row['mean_wer']:.6f} "
            f"mean_eta_raw={row['mean_eta_raw']:.6f}")
    log(f"cli study (information): noisy-row pearson_r={summary['pearson_r_noisy']}")

    conformer = archive_with_kernels(CONFORMER_ARCHIVE, f"{data_dir}/conformer_pallas.npz")
    records, _ = cli_run("conformer", conformer, f"{data_dir}/cli_conformer",
                         CONFORMER_CLI_ARGS, arch="w2v2-conformer")
    return records


PROFILE_GROUPS = (
    ("port kernels", ("dgrad_kernel", "dgrad_bf16_wgmma_kernel", "flash_fwd_kernel",
                      "flash_fwd_bf16_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel",
                      "flash_dq_bf16_kernel", "flash_dkv_bf16_kernel")),
    ("convolution (cuDNN)", ("cudnn", "convolve", "winograd", "fft", "depthwise")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
)


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_draws(f, x, bg, ec: ExplainerConfig, n: int = 2) -> dict:
    """Device time of ``n`` more draws by kernel group under torch.profiler
    (kept apart from the wall per draw above, which runs unprofiled).
    Returns {kernel name: device ms per draw}, empty if not measured."""
    draws = sample_draws(torch.Generator().manual_seed(6), n, ec.num_background)
    ec = dataclasses.replace(ec, nsamples=n)
    return profile_calls(lambda: expected_phi(f, x, bg, config=ec, draws=draws), n)


def profile_calls(fn, n: int, unit: str = "draw", tag: str = "profile",
                  host_ops: bool = True) -> dict:
    """Device time of one call of ``fn`` (``n`` units of work: draws,
    steps) by kernel group under torch.profiler: the wall with the
    profiler on, the device-busy share, the groups and the longest
    kernels, as "``tag``" lines (``host_ops``: as ``device_ms_per_call``).
    Returns {kernel name: device ms per unit}, empty if not measured."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device kernels only: a CPU op's entry repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log(f"{tag}: the profiler recorded no device time; breakdown not measured")
        return {}
    busy = sum(r[0] for r in rows)
    log(f"{tag}: {n} {unit}s, wall {wall_ms:.1f} ms per {unit} with the profiler on; "
        f"device busy {busy:.1f} ms per {unit} ({100 * busy / wall_ms:.1f}% of wall)")
    groups: dict = {}
    for ms, _, key in rows:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"{tag} group {g}: {ms:.2f} ms per {unit} ({100 * ms / busy:.1f}% of busy)")
    # the 12 longest, and every port kernel
    for i, (ms, count, key) in enumerate(rows):
        if i < 12 or _profile_group(key) == "port kernels":
            log(f"{tag} kernel {ms:9.3f} ms/{unit} {count:6.1f} calls/{unit}  {key[:100]}")
    return {key: ms for ms, _, key in rows}


def launches_per_draw(name: str, layers: int) -> int:
    """Launches of kernel ``name`` per draw of the explainer's paths
    (draw_chunk 1, output_chunk 0, remat on): the flash forward twice per
    encoder layer (the forward, and remat's recompute in the backward), the
    backward kernels once."""
    return layers * (2 if name.startswith("flash_fwd") else 1)


def phase_timing(cfg: PipelineConfig, params, test_set):
    """The base path's kernels (K1-K4) and the base slice per draw."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    mc = cfg.model
    rows = mc.frames_for_samples(N_SAMPLES)
    h, d, t = mc.num_attention_heads, mc.head_dim, rows
    layers = mc.num_hidden_layers
    out = {}

    # K1: per draw, one launch per eligible layer shape
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for k, s, ci, co, ti, to in k1_main_shapes(mc, rows):
        ybar, w = k1_inputs(gen, rows, k, ci, co, to)
        x_nct = torch.empty((rows, ci, ti), device="cuda")
        y_nct = ybar.transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        iters = 5 if to > 1000 else 20
        ms = time_ms(lambda: k1.conv1d_dgrad(ybar, w, s, ti), iters)
        pms = time_ms(lambda: k1.conv1d_dgrad_plain(ybar, w, s, ti), iters)
        lms = time_ms(lambda: torch.ops.aten.convolution_backward(
            y_nct, x_nct, w_oik, None, [s], [0], [1], False, [0], 1,
            [True, False, False]), iters)
        fl, nb = k1_cost(rows, k, s, ci, co, ti, to)
        b_ms, b_by = bound_3xtf32(fl, nb)
        log(f"timing conv_dgrad B={rows} K={k} s={s} T_out={to}: ms={ms:.4f} "
            f"plain_ms={pms:.4f} library_ms={lms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"fma_bound_ms={bound(fl, nb)[0]:.4f} TFLOP/s={fl / ms / 1e9:.2f}")
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("flops", fl), ("bytes", nb)):
            tot[key] += val
        del ybar, w, x_nct, y_nct, w_oik
    b_ms, b_by = bound_3xtf32(tot["flops"], tot["bytes"])
    log(f"timing conv_dgrad per draw: ms={tot['ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"fma_bound_ms={bound(tot['flops'], tot['bytes'])[0]:.4f}")
    out["conv_dgrad"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                             bound_by=b_by, library_ms=tot["library_ms"], device_ms=None)

    # K2: per draw, two launches per encoder layer (the forward, and remat's
    # recompute in the backward) at B*H = 12
    # host-clocked times first: a torch.profiler session leaves later
    # launches a few microseconds slower on the host
    q, k, v, bias, _ = flash_inputs(gen, 1, h, t, d, 1, False)
    ms, ms_best = host_ms(lambda: fa.flash_fwd(q, k, v, None, h))
    pms, pms_best = host_ms(lambda: fa.flash_fwd_plain(q, k, v, None, h))
    q4, k4, v4 = (x.reshape(1, h, t, d) for x in (q, k, v))
    lms, lms_best = host_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    sweep_fwd_rows("flash_fwd", q, k, v, None, h)
    dms = device_ms(lambda: fa.flash_fwd(q, k, v, None, h), "flash_fwd_kernel")
    bh = h
    fl = 4.0 * bh * t * t * d
    nb = 4.0 * (4 * bh * t * d + bh * t)
    b_ms, b_by = bound_3xtf32(fl, nb)
    log(f"timing flash_fwd BH={bh} T={t} rows/block={fa.fwd_block_rows(q)}: ms={ms:.4f} "
        f"device_ms={dms:.5f} plain_ms={pms:.4f} library_ms={lms:.4f} "
        f"bound_ms={b_ms:.5f} ({b_by}) fma_bound_ms={bound(fl, nb)[0]:.5f}; best of "
        f"{HOST_REPEATS}: ms={ms_best:.4f} plain_ms={pms_best:.4f} library_ms={lms_best:.4f}")
    r = launches_per_draw("flash_fwd", layers)
    out["flash_fwd"] = dict(ms=r * ms, plain_ms=r * pms, bound_ms=r * b_ms,
                            bound_by=b_by, library_ms=r * lms, device_ms=r * dms)

    # K3, K4: per draw, one launch each per encoder layer, 149 rows folded
    q, k, v, bias, g = flash_inputs(gen, 1, h, t, d, rows, False)
    o, lse = fa.flash_fwd(q, k, v, None, h)
    _, dd, _ = fa.flash_dq(q, k, v, o, lse, g, None, h)
    n = g.shape[0]
    qe, ke, ve = (x.reshape(1, h, t, d).expand(rows, h, t, d).contiguous().requires_grad_()
                  for x in (q, k, v))
    oe = F.scaled_dot_product_attention(qe, ke, ve)
    g4 = g.reshape(rows, h, t, d)
    lib_bwd = time_ms(lambda: torch.autograd.grad(oe, (qe, ke, ve), g4, retain_graph=True), 10)
    for name, fn, pfn, fl, nb in (
        ("flash_dq", lambda: fa.flash_dq(q, k, v, o, lse, g, None, h),
         lambda: fa.flash_dq_plain(q, k, v, o, lse, g, None, h),
         4.0 * n * t * t * d + 2.0 * bh * t * t * d,
         4.0 * (2 * n * t * d + n * t + 4 * bh * t * d + bh * t)),
        ("flash_dkv", lambda: fa.flash_dkv(q, k, v, lse, g, dd, None, h),
         lambda: fa.flash_dkv_plain(q, k, v, lse, g, dd, None, h),
         6.0 * n * t * t * d + 2.0 * bh * t * t * d,
         4.0 * (3 * n * t * d + n * t + 3 * bh * t * d + bh * t)),
    ):
        ms = time_ms(fn, 10)
        pms = time_ms(pfn, 10)
        # K3 and K4 run on the tensor cores in 3xTF32, like K1
        b_ms, b_by = bound_3xtf32(fl, nb)
        log(f"timing {name} N={n} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
            f"library_ms(SDPA backward, dq+dk+dv)={lib_bwd:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) fma_bound_ms={bound(fl, nb)[0]:.4f} TFLOP/s={fl / ms / 1e9:.2f}")
        out[name] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                         bound_by=b_by, library_ms=layers * lib_bwd, device_ms=None)
    pair = out["flash_dq"]["ms"] + out["flash_dkv"]["ms"]
    log(f"timing K3 + K4 per draw: {pair:.4f} ms ({layers} launches each) against the SDPA "
        f"backward (dq+dk+dv, same inputs) per draw {layers * lib_bwd:.4f} ms "
        f"(ratio {pair / (layers * lib_bwd):.3f})")
    del qe, ke, ve, oe

    per_draw, _ = time_slice("base", cfg, params, test_set, gen, out)
    return out, per_draw


# SDPA's backends, by a word of the names of their aten ops and device
# kernels (cuDNN's kernel names also hold "flash", so it is looked for first)
SDPA_BACKENDS = (("cudnn", "cuDNN attention"), ("flash", "flash attention"),
                 ("efficient", "memory-efficient attention"),
                 ("fmha", "memory-efficient attention"))


def sdpa_backend(label: str, fn) -> str:
    """The SDPA backend that one call of ``fn`` ran, read from the names of
    its aten ops and device kernels under torch.profiler (the op names are
    there when the profiler drops a short window's device records); logs
    the attention ops and the three longest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    names = [e.key for e in events]
    backend = next((what for word, what in SDPA_BACKENDS
                    if any(word in n.lower() for n in names)), "none of the fused backends")
    ops = sorted({n for n in names if "attention" in n.lower() and n.startswith("aten::")})
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda e: -e.self_device_time_total)
    log(f"sdpa {label}: {backend}; its aten ops {ops}; its longest device kernels "
        f"{[(round(e.self_device_time_total / 1e3, 4), e.key[:100]) for e in kernels[:3]]} (ms)")
    return backend


def host_ms(fn):
    """(one mean of 50 calls, the least of HOST_REPEATS such means): the
    first is the JSON line's ``ms``, the second is logged beside it."""
    return time_ms(fn, 50), time_ms(fn, 50, repeats=HOST_REPEATS)


def sweep_fwd_rows(name: str, q, k, v, bias, h) -> None:
    """K2 (or K2f) at each block height of fa.FWD_ROWS: host-clocked and device
    time per launch, each checked against the plain version first."""
    want = fa.flash_fwd_plain(q, k, v, bias, h)
    log(f"timing {name}: {fa.fwd_block_rows(q)} rows per block chosen for BH={q.shape[0]} "
        f"T={q.shape[1]} on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    fa._check(q, k, v, bias, h)
    fns = {rows: (lambda rows=rows: fa._fwd_launch(q, k, v, bias, h, rows))
           for rows in fa.FWD_ROWS}
    for rows, fn in fns.items():
        for x, y in zip(fn(), want):
            compare(f"{name} rows/block={rows}", x, y, 2e-5, 2e-4,
                    "float32 softmax over 149 keys, another summation order")
    # every host-clocked time before the first profiler session
    host = {rows: host_ms(fn) for rows, fn in fns.items()}
    for rows, fn in fns.items():
        log(f"timing {name} rows/block={rows}: ms={host[rows][0]:.5f} (best of "
            f"{HOST_REPEATS}: {host[rows][1]:.5f}) device_ms="
            f"{device_ms(fn, 'flash_fwd_kernel'):.5f} (per launch)")


def time_slice(label: str, cfg: PipelineConfig, params, test_set, gen, out) -> None:
    """Wall per draw of sample 0's explainer (3 draws after the pipeline
    run), launches per draw and peak device memory; then the profile.
    Returns (wall per draw in s, ``profile_draws``'s device ms by kernel)."""
    mc = cfg.model
    rows = mc.frames_for_samples(N_SAMPLES)
    x = zero_mean_unit_var(torch.from_numpy(test_set[0]["audio"]).cuda())
    bg = 0.01 * torch.randn((cfg.explainer.num_background, N_SAMPLES), device="cuda",
                            generator=gen)
    ec = dataclasses.replace(cfg.explainer, nsamples=3)
    draws = sample_draws(torch.Generator().manual_seed(5), 3, ec.num_background)
    f = make_explained_fn(params, mc, ec)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    expected_phi(f, x, bg, config=ec, draws=draws)
    torch.cuda.synchronize()
    per_draw = (time.perf_counter() - t0) / 3
    per_draw_launches = {kname: c / 3 for kname, c in LAUNCHES.items() if c}
    log(f"slice {label}: wall per draw {per_draw * 1e3:.1f} ms (3 draws, {N_SAMPLES} "
        f"samples, T_out={rows}); launches per draw {json.dumps(per_draw_launches)}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernel_sum = sum(v["ms"] for v in out.values())
    log(f"slice {label}: its {len(out)} kernels' time per draw {kernel_sum:.1f} ms "
        f"({100 * kernel_sum / (per_draw * 1e3):.1f}% of the draw's wall)")
    return per_draw, profile_draws(f, x, bg, ec)


def phase_timing_conformer(cfg: PipelineConfig, params, test_set, k1_row):
    """K2f, K3b and K4f at the conformer slice's shapes, and the conformer
    slice per draw. K1's shapes here are the base path's (the same seven
    512-channel conv layers), so its row ``k1_row`` is timed once, there.
    Returns (rows, wall per draw)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    mc = cfg.model
    rows = mc.frames_for_samples(N_SAMPLES)
    h, d, t = mc.num_attention_heads, mc.head_dim, rows
    layers = mc.num_hidden_layers
    q, k, v, _, g = flash_inputs(gen, 1, h, t, d, rows, False)
    bias = rel_pos_bias(gen, q, False)
    o, lse = fa.flash_fwd(q, k, v, bias, h)
    _, dd, _ = fa.flash_dq(q, k, v, o, lse, g, bias, h)
    n = g.shape[0]
    q4, k4, v4, b4 = (x.reshape(1, h, t, -1) for x in (q, k, v, bias))
    # the forward's host-clocked times before its profiler sessions
    fwd = lambda: fa.flash_fwd(q, k, v, bias, h)  # noqa: E731
    fwd_host = host_ms(fwd), host_ms(lambda: fa.flash_fwd_plain(q, k, v, bias, h))
    lib_fwd, lib_fwd_best = host_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4))
    # the yardstick of the backward: SDPA with a float mask that requires
    # grad, over the 149 cotangent rows as a batch: its backward alone (dq,
    # dk, dv, d(mask)) from one forward kept for it, as on the base path,
    # and forward plus backward (logged)
    qe, ke, ve = (x.expand(rows, h, t, d).contiguous().requires_grad_() for x in (q4, k4, v4))
    be = b4.expand(rows, h, t, t).contiguous().requires_grad_()
    g4 = g.reshape(rows, h, t, d)
    oe = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=be)
    lib_bwd = time_ms(lambda: torch.autograd.grad(oe, (qe, ke, ve, be), g4, retain_graph=True),
                      10)
    del oe
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qe, ke, ve, attn_mask=be), (qe, ke, ve, be), g4), 10)
    del qe, ke, ve, be
    costs = flash_costs(h, n, t, d)
    sweep_fwd_rows("flash_fwd_bias", q, k, v, bias, h)
    fwd_dms = device_ms(fwd, "flash_fwd_kernel")
    out = {}
    for name, fn, pfn, iters, lms, lib_what in (
        ("flash_fwd_bias", None, None, 50, lib_fwd, "SDPA forward, float mask"),
        ("flash_dq_dbias", lambda: fa.flash_dq(q, k, v, o, lse, g, bias, h),
         lambda: fa.flash_dq_plain(q, k, v, o, lse, g, bias, h), 10, lib_bwd,
         "SDPA backward, dq+dk+dv+d(mask)"),
        ("flash_dkv_bias", lambda: fa.flash_dkv(q, k, v, lse, g, dd, bias, h),
         lambda: fa.flash_dkv_plain(q, k, v, lse, g, dd, bias, h), 10, lib_bwd,
         "SDPA backward, dq+dk+dv+d(mask)"),
    ):
        fl, nb = costs[name]
        # all three run on the tensor cores in 3xTF32, like K1
        b_ms, b_by = bound_3xtf32(fl, nb)
        if name == "flash_fwd_bias":
            (ms, ms_best), (pms, pms_best) = fwd_host
            dms = fwd_dms
            more = (f" device_ms={dms:.5f}; best of "
                    f"{HOST_REPEATS}: ms={ms_best:.4f} plain_ms={pms_best:.4f} "
                    f"library_ms={lib_fwd_best:.4f}")
        else:
            ms, pms = time_ms(fn, iters), time_ms(pfn, iters)
            dms = None
            more = f" library_ms(SDPA forward+backward)={lib_fwd_bwd:.4f}"
        log(f"timing {name} BH={h} N={n} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
            f"library_ms({lib_what})={lms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
            f"fma_bound_ms={bound(fl, nb)[0]:.5f} TFLOP/s={fl / ms / 1e9:.2f}" + more)
        r = launches_per_draw(name, layers)
        out[name] = dict(ms=r * ms, plain_ms=r * pms, bound_ms=r * b_ms,
                         bound_by=b_by, library_ms=r * lms,
                         device_ms=None if dms is None else r * dms)
    pair = out["flash_dq_dbias"]["ms"] + out["flash_dkv_bias"]["ms"]
    log(f"timing K3b + K4f per draw: {pair:.4f} ms ({layers} launches each) against the SDPA "
        f"backward (dq+dk+dv+d(mask), same inputs) per draw {layers * lib_bwd:.4f} ms "
        f"(ratio {pair / (layers * lib_bwd):.3f}); SDPA forward+backward per draw "
        f"{layers * lib_fwd_bwd:.4f} ms")
    del q, k, v, g, bias, o, lse, dd
    per_draw, _ = time_slice("conformer", cfg, params, test_set, gen,
                             {**out, "conv_dgrad": k1_row})
    return out, per_draw

# ---------------------------------------------------------------- bf16 path

def bf16_flash_costs(bh, n, t, d):
    """(operations, bytes) of one launch of K2, K3 and K4 on bf16 inputs:
    q, k, v, o, g, dq, dk, dv at 2 bytes, lse and dd at 4, each read or
    written once, the scores counted once per residual row."""
    return {
        "flash_fwd_bf16": (4.0 * bh * t * t * d, 2.0 * 4 * bh * t * d + 4.0 * bh * t),
        "flash_dq_bf16": (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                          2.0 * (2 * n * t * d + 4 * bh * t * d) + 4.0 * (n * t + bh * t)),
        "flash_dkv_bf16": (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
                           2.0 * (3 * n * t * d + 3 * bh * t * d) + 4.0 * (n * t + bh * t)),
    }


def bf16_flash_inputs(gen, b, h, t, d, v_rows, masked):
    """``flash_inputs`` with q, k, v and g rounded to bf16 (the mask stays
    float32, as the kernels take it)."""
    q, k, v, bias, g = flash_inputs(gen, b, h, t, d, v_rows, masked)
    return q.to(BF16), k.to(BF16), v.to(BF16), bias, g.to(BF16)


def fwd_float64_check_bf16(gen, h: int, d: int, t: int, full: bool = False) -> dict:
    """K2 (``full``: K2f, with a rel-pos-like bias) in bf16 and its plain
    version against the same bf16 inputs in float64: o to at most
    BF16_F64_RATIO times the plain version's error, lse (a float32 output)
    to at most BF16_F32_OUT_RATIO times."""
    q, k, v, _, _ = bf16_flash_inputs(gen, 1, h, t, d, 1, False)
    bias = rel_pos_bias(gen, q, False) if full else None
    o64, lse64 = fa.flash_fwd_plain(q.double(), k.double(), v.double(),
                                    None if bias is None else bias.double(), h)
    name = "flash_fwd_bias_bf16" if full else "flash_fwd_bf16"
    errs = {}
    for key, (o, lse) in (("kernel", fa.flash_fwd(q, k, v, bias, h)),
                          ("plain", fa.flash_fwd_plain(q, k, v, bias, h))):
        errs[key, "o"] = compare_bf16(f"{name} o BH={h} T={t}: {key} vs float64", o,
                                      o64, 0.0, 0.0, "")
        errs[key, "lse"] = compare(f"{name} lse BH={h} T={t}: {key} vs float64",
                                   lse.double(), lse64, 2e-5, 2e-4,
                                   "float32 softmax over 149 keys, against the exact sum")
    for part, ratio in (("o", BF16_F64_RATIO), ("lse", BF16_F32_OUT_RATIO)):
        kern, plain = errs["kernel", part], errs["plain", part]
        log(f"{name} {part} vs float64: kernel {kern:.3e}, plain {plain:.3e} "
            f"(ratio {kern / plain:.2f}, limit {ratio})")
        check(kern <= ratio * plain, f"{name} {part}: error over {ratio}x the plain "
              "version's against float64")
    return {"err_vs_float64": errs["kernel", "o"], "plain_err_vs_float64": errs["plain", "o"]}


def phase_checks_bf16(cfg: Wav2Vec2Config):
    """K1-K4 in bf16 against their plain versions at the bf16 path's shapes
    (the base path's: K1 at the six layers with 149 rows; K2-K4 at BH = 12,
    T = 149, D = 64, N = 1,788, masked and unmasked; K2 also over
    ``check_fwd_lengths``'s key counts and at the sweep's batched shapes;
    K3, K4 over ``check_bwd_shapes``'s sweep with D = 32 at T = 312), and
    against float64 on the same bf16 inputs."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = cfg.frames_for_samples(N_SAMPLES)
    h, d, t = cfg.num_attention_heads, cfg.head_dim, rows
    errs = {name: 0.0 for name in BF16_KERNELS}
    shapes = k1_main_shapes(cfg, rows)
    for k, s, ci, co, ti, to in shapes:
        ybar, w = (x.to(BF16) for x in k1_inputs(gen, rows, k, ci, co, to))
        got = k1.conv1d_dgrad(ybar, w, s, ti)
        check(got.dtype == BF16, f"conv_dgrad_bf16 returned {got.dtype}")
        errs["conv_dgrad_bf16"] = max(errs["conv_dgrad_bf16"], compare_bf16(
            f"conv_dgrad_bf16 B={rows} K={k} s={s} C={ci}x{co} T_out={to}", got,
            k1.conv1d_dgrad_plain(ybar, w, s, ti), 0.0, 0.0, ""))
        del ybar, w, got
    # against float64 at every main-path shape: the JSON line takes the
    # largest errors
    f64 = [k1_float64_check(gen, rows, *shape, dtype=BF16) for shape in shapes]
    edge_err, edge_ratio = check_k1_bf16_edges(gen)
    errs["conv_dgrad_bf16"] = max(errs["conv_dgrad_bf16"], edge_err)
    extra = {"conv_dgrad_bf16": {"err_vs_float64": max(e["kernel"] for e in f64),
                                 "plain_err_vs_float64": max(e["plain"] for e in f64),
                                 "edge_f64_ratio": edge_ratio}}

    why_f = "float32 softmax over T keys, another summation order"
    why_b = "float32 backward sums over 149 keys, another summation order"
    for masked in (False, True):
        for b, hh, tt, dd_ in ((1, h, t, d), (5, h, t, d), (1, 3, 312, 32)):
            q, k, v, bias, _ = bf16_flash_inputs(gen, b, hh, tt, dd_, 1, masked)
            (o, lse), (o_p, lse_p) = (fa.flash_fwd(q, k, v, bias, hh),
                                      fa.flash_fwd_plain(q, k, v, bias, hh))
            check(o.dtype == BF16 and lse.dtype == torch.float32, "flash_fwd_bf16 dtypes")
            label = f"BH={b * hh} T={tt} D={dd_} mask={masked}"
            errs["flash_fwd_bf16"] = max(
                errs["flash_fwd_bf16"],
                compare_bf16(f"flash_fwd_bf16 o {label}", o, o_p, 2e-5, 2e-4, why_f),
                compare_bf16(f"flash_fwd_bf16 lse {label}", lse, lse_p, 2e-5, 2e-4, why_f))
        q, k, v, bias, g = bf16_flash_inputs(gen, 1, h, t, d, rows, masked)
        o, lse = fa.flash_fwd_plain(q, k, v, bias, h)
        dq, dd, _ = fa.flash_dq(q, k, v, o, lse, g, bias, h)
        dq_p, dd_p, _ = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
        check(dq.dtype == BF16 and dd.dtype == torch.float32, "flash_dq_bf16 dtypes")
        n = g.shape[0]
        errs["flash_dq_bf16"] = max(
            errs["flash_dq_bf16"],
            compare_bf16(f"flash_dq_bf16 dq N={n} mask={masked}", dq, dq_p, 5e-5, 5e-4, why_b),
            compare_bf16(f"flash_dq_bf16 dd N={n} mask={masked}", dd, dd_p, 5e-5, 5e-4, why_b))
        dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
        check(dk.dtype == BF16 and dv.dtype == BF16, "flash_dkv_bf16 dtypes")
        errs["flash_dkv_bf16"] = max(
            errs["flash_dkv_bf16"],
            compare_bf16(f"flash_dkv_bf16 dk N={n} mask={masked}", dk, dk_p, 5e-5, 5e-4, why_b),
            compare_bf16(f"flash_dkv_bf16 dv N={n} mask={masked}", dv, dv_p, 5e-5, 5e-4, why_b))
        del q, k, v, bias, g, o, lse, dq, dd, dq_p, dd_p, dk, dv, dk_p, dv_p
    errs["flash_fwd_bf16"] = max(errs["flash_fwd_bf16"], check_fwd_lengths(gen, h, d, False, BF16),
                                 check_fwd_sweep_shapes(gen, BF16))
    for key, err in check_bwd_shapes(gen, h, dtype=BF16).items():
        errs[key] = max(errs[key], err)
    extra["flash_fwd_bf16"] = fwd_float64_check_bf16(gen, h, d, t)
    extra.update(bwd_float64_check(gen, h, d, t, rows, dtype=BF16))
    return errs, extra


def eg_passes(ec: ExplainerConfig, t_out: int) -> tuple:
    """(chunks, backward calls per chunk, forward passes per chunk) of one
    expected-gradients explanation: ``num_draws`` draws in chunks of
    ``draw_chunk``; per chunk one forward of the chunk's draws, one backward
    call per slice of ``output_chunk`` cotangent rows, and with ``remat``
    the encoder layers' forward again in each backward call."""
    chunks = num_draws(ec) // max(1, ec.draw_chunk)
    oc = ec.output_chunk
    calls = -(-t_out // oc) if 0 < oc < t_out else 1
    return chunks, calls, 1 + (calls if ec.remat else 0)


def expected_launches_eg(cfg: PipelineConfig, samples: int, n_samples: int = N_SAMPLES,
                         transcripts: int = 1) -> dict:
    """Launches of each kernel of the path on an expected-gradients run of
    ``samples`` clips of ``n_samples``: per sample ``transcripts`` forwards,
    then per draw chunk (``eg_passes``) the flash forward (K2 or K2f) once
    per encoder layer and forward pass, K1 once per eligible conv layer and
    backward call, K3/K4 (K3b/K4f) once per encoder layer and backward call:

      K2 = samples * (transcripts + chunks * (1 + remat * calls)) * layers
      K3 = K4 = samples * chunks * calls * layers,  K1 = samples * chunks * calls * convs"""
    layers, mc = cfg.model.num_hidden_layers, cfg.model
    chunks, calls, passes = eg_passes(cfg.explainer, mc.frames_for_samples(n_samples))
    convs = len(k1_main_shapes(mc, 1, n_samples))
    k1_, fwd, dq, dkv = path_kernels(mc)
    want = {k1_: samples * chunks * calls * convs,
            fwd: samples * (transcripts + chunks * passes) * layers,
            dq: samples * chunks * calls * layers, dkv: samples * chunks * calls * layers}
    return {name: n for name, n in want.items() if n}


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a.ravel().double(), b.ravel().double()]))[0, 1])


def defined_frames(label: str, logits: dict) -> torch.Tensor:
    """[T] mask of the frames whose max head is defined at bf16: the top two
    float32 logits (logits["32"], [T, V]) further apart than twice the
    larger of the two bf16 paths' (logits["k16"], logits["p16"]) largest
    logit errors at that frame. Fails if under a tenth of the frames are."""
    err = torch.maximum((logits["k16"] - logits["32"]).abs().amax(-1),
                        (logits["p16"] - logits["32"]).abs().amax(-1))
    top2 = logits["32"].topk(2, dim=-1).values
    defined = (top2[:, 0] - top2[:, 1]) > 2 * err
    t_out = defined.numel()
    log(f"{label}: max|logit| float32 {float(logits['32'].abs().max()):.4e}; largest logit "
        f"error at the input: kernels {float((logits['k16'] - logits['32']).abs().max()):.4e}, "
        f"plain {float((logits['p16'] - logits['32']).abs().max()):.4e}; max head defined "
        f"at bf16 on {int(defined.sum())} of {t_out} frames")
    check(int(defined.sum()) >= t_out // 10, f"{label}: the max head is defined on under a "
          "tenth of the frames; the comparison would say nothing")
    return defined


def phi_rule(label: str, phi: dict, frame_sets) -> None:
    """The bf16 rule for phi [N, T_out]: the kernel path (phi["k16"]) no
    further from float32 (phi["32"]) than 1.5x the plain bf16 path
    (phi["p16"]), and correlating with it at least as well less 0.01. Logged
    on each (name, frame selection) of ``frame_sets``, gated on the last."""
    ref = phi["32"]
    for frames, sel in frame_sets:
        nk = float((phi["k16"][:, sel] - ref[:, sel]).norm())
        np_ = float((phi["p16"][:, sel] - ref[:, sel]).norm())
        ck, cp = _corr(phi["k16"][:, sel], ref[:, sel]), _corr(phi["p16"][:, sel], ref[:, sel])
        log(f"{label} ({frames}): |phi_k16 - phi_32| = {nk:.6e}, |phi_p16 - phi_32| = "
            f"{np_:.6e} (ratio {nk / np_:.3f}, limit 1.5), |phi_32| = "
            f"{float(ref[:, sel].norm()):.6e}; corr(phi_k16, phi_32) = {ck:.6f}, "
            f"corr(phi_p16, phi_32) = {cp:.6f}")
    check(nk <= 1.5 * np_, f"{label}: the kernel path is further from float32 than 1.5x "
          "the plain bf16 path")
    check(ck >= cp - 0.01, f"{label}: the kernel path correlates less with float32 than "
          "the plain bf16 path, by over 0.01")


def phase_reference_bf16(label: str, cfg: PipelineConfig, params, test_set):
    """One full-width draw three ways: bf16 + "default" through the kernels
    (phi_k16), bf16 + "default" through plain PyTorch (phi_p16) and float32
    + "highest" through the kernels (phi_32). The kernel path must be no
    further from phi_32 than the plain bf16 path (norm at most 1.5x, corr at
    least its corr less 0.01) on every frame whose max head is defined at
    bf16: the top two float32 logits at x_t further apart than twice the
    larger of the two bf16 paths' largest logit errors at that frame, so no
    bf16 path can pick another token there. On the other frames either bf16
    path may explain another token's logit; they are logged, not gated.
    Also logs the relative move of the |phi| checksum of bf16 + "default"
    and of float32 + "default" against float32 + "highest"."""
    ec = dataclasses.replace(cfg.explainer, nsamples=1)
    x = zero_mean_unit_var(torch.from_numpy(test_set[1]["audio"]).cuda())
    bg = 0.01 * torch.randn((ec.num_background, N_SAMPLES),
                            generator=torch.Generator().manual_seed(1)).cuda()
    draws = (torch.tensor([2]), torch.tensor([0.37]))
    x_t = bg[2] + 0.37 * (x - bg[2])
    k16 = cfg.model
    p16 = dataclasses.replace(k16, attention_impl="xla", conv_impl="lax")
    k32 = dataclasses.replace(k16, dtype="float32", matmul_precision="highest")
    k32d = dataclasses.replace(k16, dtype="float32")
    params16 = cast_params_for_compute(params, "bfloat16")
    paths = {"k16": (k16, params16), "p16": (p16, params16), "32": (k32, params),
             "32 default": (k32d, params)}
    phi, logits = {}, {}
    model_logits = model_logits_fn(k16)
    for key, (mc, p) in paths.items():
        with matmul_precision_scope(mc.matmul_precision):
            phi[key] = expected_phi(make_explained_fn(p, mc, ec), x, bg, config=ec, draws=draws)
            with torch.no_grad():
                logits[key] = model_logits(p, mc, x_t[None])[0]
        check(phi[key].dtype == torch.float32, f"{label} {key}: {phi[key].dtype}")
        check(bool(torch.isfinite(phi[key]).all()), f"{label} {key}: not finite")
    defined = defined_frames(label, logits)
    phi_rule(label, phi, (("all frames", slice(None)), ("defined frames", defined)))
    ref = phi["32"]
    s32 = float(ref.abs().sum())
    for key in ("k16", "32 default"):
        s = float(phi[key].abs().sum())
        log(f"{label} checksum sum|phi| {key}: {s:.6e} against float32 + highest {s32:.6e}: "
            f"relative move {(s - s32) / s32:+.4e}; relative L2 distance "
            f"{float((phi[key] - ref).norm() / ref.norm()):.4e}")


def phase_timing_bf16(cfg: PipelineConfig, params16, test_set):
    """K1-K4 in bf16 at the bf16 path's shapes: each kernel's time per draw
    (CUDA events) beside its bound at the bf16 rate, its plain version and
    one library call (cuDNN's bf16 dgrad, SDPA's bf16 forward and backward
    without a mask, as the path runs); then the bf16 slice per draw. Each
    kernel's device time per draw comes from the slice's profile (K2's
    host-clocked time is its launch latency, not device time). Returns
    (rows, wall per draw)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    mc = cfg.model
    rows = mc.frames_for_samples(N_SAMPLES)
    h, d, t = mc.num_attention_heads, mc.head_dim, rows
    layers = mc.num_hidden_layers
    out = {}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for k, s, ci, co, ti, to in k1_main_shapes(mc, rows):
        ybar, w = (x.to(BF16) for x in k1_inputs(gen, rows, k, ci, co, to))
        x_nct = torch.empty((rows, ci, ti), device="cuda", dtype=BF16)
        y_nct = ybar.transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        iters = 5 if to > 1000 else 20
        fn = lambda: k1.conv1d_dgrad(ybar, w, s, ti)  # noqa: E731
        ms = time_ms(fn, iters)
        pms = time_ms(lambda: k1.conv1d_dgrad_plain(ybar, w, s, ti), iters)
        lms = time_ms(lambda: torch.ops.aten.convolution_backward(
            y_nct, x_nct, w_oik, None, [s], [0], [1], False, [0], 1,
            [True, False, False]), iters)
        fl, nb32 = k1_cost(rows, k, s, ci, co, ti, to)
        nb = nb32 / 2  # bf16 operands and output
        b_ms, b_by = bound_bf16(fl, nb)
        log(f"timing conv_dgrad_bf16 B={rows} K={k} s={s} T_out={to}: ms={ms:.4f} "
            f"plain_ms={pms:.4f} library_ms(cuDNN bf16 dgrad)={lms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}) TFLOP/s={fl / ms / 1e9:.2f}")
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("flops", fl), ("bytes", nb)):
            tot[key] += val
        del ybar, w, x_nct, y_nct, w_oik
    b_ms, b_by = bound_bf16(tot["flops"], tot["bytes"])
    log(f"timing conv_dgrad_bf16 per draw: ms={tot['ms']:.4f} bound_ms={b_ms:.4f} ({b_by})")
    out["conv_dgrad_bf16"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                                  bound_by=b_by, library_ms=tot["library_ms"], device_ms=None)

    costs = bf16_flash_costs(h, rows * h, t, d)
    q, k, v, _, g = bf16_flash_inputs(gen, 1, h, t, d, rows, False)
    ms, ms_best = host_ms(lambda: fa.flash_fwd(q, k, v, None, h))
    pms, pms_best = host_ms(lambda: fa.flash_fwd_plain(q, k, v, None, h))
    q4, k4, v4 = (x.reshape(1, h, t, d) for x in (q, k, v))
    lms, lms_best = host_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    fl, nb = costs["flash_fwd_bf16"]
    b_ms, b_by = bound_bf16(fl, nb)
    log(f"timing flash_fwd_bf16 BH={h} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
        f"library_ms(SDPA bf16 forward)={lms:.4f} bound_ms={b_ms:.5f} ({b_by}); best of "
        f"{HOST_REPEATS}: ms={ms_best:.4f} plain_ms={pms_best:.4f} library_ms={lms_best:.4f}")
    r = launches_per_draw("flash_fwd_bf16", layers)
    out["flash_fwd_bf16"] = dict(ms=r * ms, plain_ms=r * pms, bound_ms=r * b_ms,
                                 bound_by=b_by, library_ms=r * lms, device_ms=None)

    o, lse = fa.flash_fwd(q, k, v, None, h)
    _, dd, _ = fa.flash_dq(q, k, v, o, lse, g, None, h)
    qe, ke, ve = (x.expand(rows, h, t, d).contiguous().requires_grad_() for x in (q4, k4, v4))
    oe = F.scaled_dot_product_attention(qe, ke, ve)
    g4 = g.reshape(rows, h, t, d)
    lib_bwd = time_ms(lambda: torch.autograd.grad(oe, (qe, ke, ve), g4, retain_graph=True), 10)
    backend = sdpa_backend("bf16 backward, no mask", lambda: torch.autograd.grad(
        oe, (qe, ke, ve), g4, retain_graph=True))
    for name, fn, pfn in (
        ("flash_dq_bf16", lambda: fa.flash_dq(q, k, v, o, lse, g, None, h),
         lambda: fa.flash_dq_plain(q, k, v, o, lse, g, None, h)),
        ("flash_dkv_bf16", lambda: fa.flash_dkv(q, k, v, lse, g, dd, None, h),
         lambda: fa.flash_dkv_plain(q, k, v, lse, g, dd, None, h)),
    ):
        ms, pms = time_ms(fn, 10), time_ms(pfn, 10)
        fl, nb = costs[name]
        b_ms, b_by = bound_bf16(fl, nb)
        log(f"timing {name} N={rows * h} T={t}: ms={ms:.4f} "
            f"plain_ms={pms:.4f} library_ms(SDPA bf16 backward, {backend}, dq+dk+dv)="
            f"{lib_bwd:.4f} bound_ms={b_ms:.4f} ({b_by}) TFLOP/s={fl / ms / 1e9:.2f}")
        out[name] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                         bound_by=b_by, library_ms=layers * lib_bwd, device_ms=None)
    pair = out["flash_dq_bf16"]["ms"] + out["flash_dkv_bf16"]["ms"]
    log(f"timing K3 + K4 bf16 per draw: {pair:.4f} ms ({layers} launches each) against the "
        f"SDPA bf16 backward (dq+dk+dv, same inputs) per draw {layers * lib_bwd:.4f} ms "
        f"(ratio {pair / (layers * lib_bwd):.3f})")
    del q, k, v, g, o, lse, dd, qe, ke, ve, oe
    time_conv_dgrad_bf16("positional conv", rows, mc.hidden_size, mc.num_conv_pos_embeddings,
                         mc.num_conv_pos_embedding_groups, mc.matmul_precision, gen,
                         (("cuDNN bf16", BF16, 3), ("float32 copies", torch.float32, 10)))
    with matmul_precision_scope(mc.matmul_precision):
        per_draw, prof = time_slice("bf16", cfg, params16, test_set, gen, out)
    for name, kname in (("conv_dgrad_bf16", "dgrad_bf16_wgmma_kernel"),
                        ("flash_fwd_bf16", "flash_fwd_bf16_kernel"),
                        ("flash_dq_bf16", "flash_dq_bf16_kernel"),
                        ("flash_dkv_bf16", "flash_dkv_bf16_kernel")):
        seen = [ms for key, ms in prof.items() if kname in key]
        out[name]["device_ms"] = sum(seen) if seen else None
        log(f"timing {name}: device ms per draw {out[name]['device_ms']} (the slice's "
            f"profile; None: not measured)")
    return out, per_draw


def time_conv_dgrad_bf16(name: str, rows: int, c: int, k: int, groups: int,
                         precision: str, gen, turns) -> None:
    """The input gradient of a grouped conv (C channels, kernel K, padding
    K // 2) over ``rows`` cotangent rows of ``rows`` frames, as the library
    runs it in bf16 and as the model runs it (float32 copies, TF32 under
    "default"; ``models/wav2vec2.py::_conv1d``), in ``turns`` of (label,
    dtype, calls timed): why a bf16 grouped conv runs in float32."""
    x = torch.randn((rows, c, rows), generator=gen, device="cuda")
    w = torch.randn((c, c // groups, k), generator=gen, device="cuda")
    g = torch.randn((rows, c, rows + 2 * (k // 2) - k + 1), generator=gen, device="cuda")
    with matmul_precision_scope(precision):
        for label, dt, iters in turns:
            xd, wd, gd = (t.to(dt) for t in (x, w, g))
            ms = time_ms(lambda: torch.ops.aten.convolution_backward(
                gd, xd, wd, None, [1], [k // 2], [1], False, [0], groups,
                [True, False, False]), iters, warmup=1)
            log(f"timing {name} dgrad B={rows} C={c} K={k} groups={groups} "
                f"({label}, {precision}): {ms:.4f} ms per call")


def phase_cli_bench(data_dir: str):
    """``python -m asr_shap_torch bench --attn pallas`` in this process at its
    defaults (Wav2Vec2-base, bf16, "default"): every row "ok", the bf16
    flash kernels launched and no float32 kernel."""
    path = f"{data_dir}/bench.json"
    _, launches, wall = run_cli("bench", ["bench", "--attn", "pallas", "--lengths", "16000",
                                          "48000", "--nsamples", str(NSAMPLES), "--json", path])
    with open(path) as fh:
        rows = json.load(fh)
    for row in rows:
        log(f"cli bench row: {json.dumps(row)}")
    check(len(rows) == 2 and all(r["status"] == "ok" for r in rows),
          f"cli bench: rows {rows}")
    for name in ("flash_fwd_bf16", "flash_dq_bf16", "flash_dkv_bf16"):
        check(launches.get(name, 0) > 0, f"cli bench: {name} not launched")
    check(not any(launches.get(name, 0) for name in BASE_KERNELS + CONFORMER_KERNELS),
          f"cli bench: a float32 kernel launched: {launches}")


def phase_bf16(model16: Wav2Vec2Config, explainer: ExplainerConfig, test_set, data_dir: str,
               f32_per_draw: float):
    """The bf16 path: checks, run_shap_pipeline with exact launch counts and
    no float32 kernel, the three-way draw, timing and the bench command.
    Returns (errors, extra fields, launches, timing rows)."""
    errs, extra = phase_checks_bf16(model16)
    cfg = PipelineConfig(model=model16, explainer=explainer, seed=SEED,
                         data_dir=f"{data_dir}/bf16")
    params = init_wav2vec2_params(SEED, model16, device="cuda")  # float32 master params
    launches = phase_pipeline("bf16", cfg, params, test_set, BF16_KERNELS)
    want = expected_launches_eg(cfg, len(test_set))
    check(want == {"conv_dgrad_bf16": 48, "flash_fwd_bf16": 216, "flash_dq_bf16": 96,
                   "flash_dkv_bf16": 96}, f"bf16 path: expected counts {want}")
    for name, n in want.items():
        check(launches[name] == n, f"bf16 path: {name} launched {launches[name]} times, "
              f"{n} expected")
    check(not any(launches[name] for name in BASE_KERNELS + CONFORMER_KERNELS),
          f"bf16 path: a float32 kernel launched: {launches}")
    phase_reference_bf16("phi bf16", cfg, params, test_set)
    out, per_draw = phase_timing_bf16(cfg, cast_params_for_compute(params, "bfloat16"),
                                      test_set)
    log(f"slice bf16: wall per draw {per_draw * 1e3:.1f} ms against the float32 path's "
        f"{f32_per_draw * 1e3:.1f} ms in this run (ratio {per_draw / f32_per_draw:.3f})")
    del params
    phase_cli_bench(data_dir)
    return errs, extra, launches, out


# ---------------------------------------------------------------- bf16 conformer

def bf16_full_flash_costs(bh, n, t, d):
    """(operations, bytes) of one launch of K2f, K3b and K4f on bf16 inputs:
    q, k, v, o, g, dq, dk, dv at 2 bytes; lse, dd, the bias and d(bias) at
    4; each read or written once, the scores counted once per residual row."""
    return {
        "flash_fwd_bias_bf16": (4.0 * bh * t * t * d,
                                2.0 * 4 * bh * t * d + 4.0 * (bh * t + bh * t * t)),
        "flash_dq_dbias_bf16": (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                                2.0 * (2 * n * t * d + 4 * bh * t * d)
                                + 4.0 * (n * t + n * t * t + bh * t + bh * t * t)),
        "flash_dkv_bias_bf16": (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
                                2.0 * (3 * n * t * d + 3 * bh * t * d)
                                + 4.0 * (n * t + bh * t + bh * t * t)),
    }


def phase_timing_bf16_conformer(cfg: PipelineConfig, params16, test_set):
    """K2f, K3b and K4f in bf16 at the bf16 conformer's shapes: each one's
    time per draw (CUDA events) beside its bound at the bf16 rate (bytes at
    2 per bf16 and 4 per float32 element), its plain version and SDPA in
    bf16 with a bf16 float mask (forward; backward alone with d(mask), the
    forward plus backward logged); then the depthwise conv's dgrad both
    ways (``time_conv_dgrad_bf16``) and the slice per draw, whose profile
    gives each kernel's device time per draw. K1-bf16's shapes are the bf16
    base path's, timed there. Returns (rows, wall per draw)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    mc = cfg.model
    rows = mc.frames_for_samples(N_SAMPLES)
    h, d, t = mc.num_attention_heads, mc.head_dim, rows
    layers = mc.num_hidden_layers
    q, k, v, _, g = bf16_flash_inputs(gen, 1, h, t, d, rows, False)
    bias = rel_pos_bias(gen, q, False)
    o, lse = fa.flash_fwd(q, k, v, bias, h)
    _, dd, _ = fa.flash_dq(q, k, v, o, lse, g, bias, h)
    n = g.shape[0]
    fwd = lambda: fa.flash_fwd(q, k, v, bias, h)  # noqa: E731
    fwd_host = host_ms(fwd), host_ms(lambda: fa.flash_fwd_plain(q, k, v, bias, h))
    q4, k4, v4 = (x.reshape(1, h, t, d) for x in (q, k, v))
    b4 = bias.to(BF16).reshape(1, h, t, t)
    lib_fwd, lib_fwd_best = host_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=b4))
    qe, ke, ve = (x.expand(rows, h, t, d).contiguous().requires_grad_() for x in (q4, k4, v4))
    be = b4.expand(rows, h, t, t).contiguous().requires_grad_()
    g4 = g.reshape(rows, h, t, d)
    oe = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=be)
    lib_bwd = time_ms(lambda: torch.autograd.grad(oe, (qe, ke, ve, be), g4, retain_graph=True),
                      10)
    backend = sdpa_backend("bf16 backward, bf16 float mask", lambda: torch.autograd.grad(
        oe, (qe, ke, ve, be), g4, retain_graph=True))
    del oe
    lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qe, ke, ve, attn_mask=be), (qe, ke, ve, be), g4), 10)
    del qe, ke, ve, be
    costs = bf16_full_flash_costs(h, n, t, d)
    out = {}
    for name, fn, pfn, lms, lib_what in (
        ("flash_fwd_bias_bf16", None, None, lib_fwd, "SDPA bf16 forward, bf16 mask"),
        ("flash_dq_dbias_bf16", lambda: fa.flash_dq(q, k, v, o, lse, g, bias, h),
         lambda: fa.flash_dq_plain(q, k, v, o, lse, g, bias, h), lib_bwd,
         f"SDPA bf16 backward, {backend}, dq+dk+dv+d(mask)"),
        ("flash_dkv_bias_bf16", lambda: fa.flash_dkv(q, k, v, lse, g, dd, bias, h),
         lambda: fa.flash_dkv_plain(q, k, v, lse, g, dd, bias, h), lib_bwd,
         f"SDPA bf16 backward, {backend}, dq+dk+dv+d(mask)"),
    ):
        fl, nb = costs[name]
        b_ms, b_by = bound_bf16(fl, nb)
        if fn is None:
            (ms, ms_best), (pms, pms_best) = fwd_host
            more = (f"; best of {HOST_REPEATS}: ms={ms_best:.4f} plain_ms={pms_best:.4f} "
                    f"library_ms={lib_fwd_best:.4f}")
        else:
            ms, pms = time_ms(fn, 10), time_ms(pfn, 10)
            more = f" library_ms(SDPA bf16 forward+backward)={lib_fwd_bwd:.4f}"
        log(f"timing {name} BH={h} N={n} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
            f"library_ms({lib_what})={lms:.4f} bound_ms={b_ms:.5f} ({b_by}) "
            f"TFLOP/s={fl / ms / 1e9:.2f} GB/s={nb / ms / 1e6:.1f}" + more)
        r = launches_per_draw(name, layers)
        out[name] = dict(ms=r * ms, plain_ms=r * pms, bound_ms=r * b_ms,
                         bound_by=b_by, library_ms=r * lms, device_ms=None)
    pair = out["flash_dq_dbias_bf16"]["ms"] + out["flash_dkv_bias_bf16"]["ms"]
    log(f"timing K3b + K4f bf16 per draw: {pair:.4f} ms ({layers} launches each) against the "
        f"SDPA bf16 backward (dq+dk+dv+d(mask), same inputs) per draw {layers * lib_bwd:.4f} ms "
        f"(ratio {pair / (layers * lib_bwd):.3f}); SDPA forward+backward per draw "
        f"{layers * lib_fwd_bwd:.4f} ms")
    del q, k, v, g, bias, o, lse, dd
    # the library's bf16 route and the model's in turns, twice
    time_conv_dgrad_bf16("depthwise conv", rows, mc.hidden_size, mc.conv_depthwise_kernel_size,
                         mc.hidden_size, mc.matmul_precision, gen,
                         (("library bf16", BF16, 10), ("float32 copies", torch.float32, 10)) * 2)
    with matmul_precision_scope(mc.matmul_precision):
        per_draw, prof = time_slice("bf16 conformer", cfg, params16, test_set, gen, out)
    for name, kname in (("flash_fwd_bias_bf16", "flash_fwd_bf16_kernel"),
                        ("flash_dq_dbias_bf16", "flash_dq_bf16_kernel"),
                        ("flash_dkv_bias_bf16", "flash_dkv_bf16_kernel")):
        seen = [ms for key, ms in prof.items() if kname in key]
        out[name]["device_ms"] = sum(seen) if seen else None
        log(f"timing {name}: device ms per draw {out[name]['device_ms']} (the slice's "
            f"profile; None: not measured)")
    return out, per_draw


def phase_cli_bf16_conformer(data_dir: str, f32_records):
    """``run-shap`` then ``sweep`` on the trained conformer archive switched
    to bf16 + "default" and the kernel impls (3 heads of 32): only its bf16
    kernels launch, phi is finite, and the sweep's rows are complete; WER,
    eta_raw and transcripts are logged beside the float32 archive's sweep
    (argmax ties may flip at bf16, so they are not gated)."""
    archive = archive_with_kernels(CONFORMER_ARCHIVE, f"{data_dir}/conformer_bf16.npz",
                                   dtype="bfloat16", matmul_precision="default")
    d = f"{data_dir}/cli_conformer_bf16"
    records, _ = cli_run("conformer bf16", archive, d, CONFORMER_CLI_ARGS,
                         arch="w2v2-conformer")
    check(len(records) == len(f32_records) and all(
        r.keys() == f.keys() for r, f in zip(records, f32_records)),
        "cli conformer bf16: the sweep's rows differ from the float32 sweep's")
    t_out = load_config(archive).frames_for_samples(N_SAMPLES)
    for r, f in zip(records, f32_records):
        phi = np.load(f"{d}/shap_values_sample_{r['index']}_{r['type']}_{r['snr']}.npy")
        check(phi.shape == (N_SAMPLES, t_out) and bool(np.isfinite(phi).all()),
              f"cli conformer bf16: phi {phi.shape} not finite or not [{N_SAMPLES}, {t_out}]")
        log(f"cli conformer bf16 (information): {r['type']} snr={r['snr']}: wer bf16 "
            f"{r['wer']:.6f} float32 {f['wer']:.6f}; eta_raw bf16 {r['eta_raw']:.6f} float32 "
            f"{f['eta_raw']:.6f}; hypothesis bf16 {r['hypothesis']!r} float32 "
            f"{f['hypothesis']!r}")


def phase_bf16_conformer(model16: Wav2Vec2ConformerConfig, explainer: ExplainerConfig,
                         test_set, data_dir: str, f32_per_draw: float, f32_cli_records):
    """The bf16 conformer: checks, run_shap_pipeline with exact launch
    counts and no other kernel, the three-way draw, timing and the command
    line. Returns (errors, extra fields, launches, timing rows)."""
    errs, extra = phase_checks_full_bias(model16, BF16)
    cfg = PipelineConfig(model=model16, explainer=explainer, seed=SEED,
                         data_dir=f"{data_dir}/bf16_conformer")
    params = init_w2v2_conformer_params(SEED, model16, device="cuda")  # float32 masters
    launches = phase_pipeline("bf16 conformer", cfg, params, test_set, BF16_CONFORMER_KERNELS)
    want = expected_launches_eg(cfg, len(test_set))
    check(want == {"conv_dgrad_bf16": 48, "flash_fwd_bias_bf16": 432,
                   "flash_dq_dbias_bf16": 192, "flash_dkv_bias_bf16": 192},
          f"bf16 conformer: expected counts {want}")
    for name, count in launches.items():
        check(count == want.get(name, 0), f"bf16 conformer: {name} launched {count} times, "
              f"{want.get(name, 0)} expected")
    phase_reference_bf16("phi bf16 conformer", cfg, params, test_set)
    out, per_draw = phase_timing_bf16_conformer(
        cfg, cast_params_for_compute(params, "bfloat16"), test_set)
    log(f"slice bf16 conformer: wall per draw {per_draw * 1e3:.1f} ms against the float32 "
        f"conformer's {f32_per_draw * 1e3:.1f} ms in this run (ratio "
        f"{per_draw / f32_per_draw:.3f})")
    del params
    phase_cli_bf16_conformer(data_dir, f32_cli_records)
    return errs, extra, launches, out


# ---------------------------------------------------------------- explainers

METHODS = ("deep", "kernel", "lime")
# DeepSHAP's background rows; KernelSHAP's coalitions and LIME's
# perturbations per sample (4 batches of 16 whole clips) over 32 segments
DEEP_BACKGROUND, COALITIONS, SEGMENTS = 5, 64, 32
# the perturbation explainers' batch of whole clips (explain/kernel_shap.py)
CLIP_BATCH = 16
# the command line on the trained conformer archive, on the card and the CPU
EXPLAINER_CLI_ARGS = ("--num-samples", "1", "--snrs", "5", "--min-length", str(N_SAMPLES),
                      "--max-length", str(N_SAMPLES), "--num-background", "2",
                      "--nsamples", "32", "--kernel-segments", "16")


def method_config(explainer: ExplainerConfig, method: str) -> ExplainerConfig:
    return dataclasses.replace(explainer, method=method, num_background=DEEP_BACKGROUND,
                               nsamples=COALITIONS, kernel_num_segments=SEGMENTS,
                               lime_num_samples=COALITIONS, lime_num_segments=SEGMENTS)


def expected_launches_method(cfg: PipelineConfig, samples: int) -> dict:
    """Launches of each kernel on a pipeline run of the deep, kernel or lime
    method (no k-means) on clips of N_SAMPLES, counted from the code: per
    sample one forward for the transcript; DeepSHAP per background row one
    forward of the dual batch and one backward per chunk of
    ``output_chunk`` cotangent rows (with ``remat`` each backward runs the
    encoder layers' forward again), then f at (x, x) and at each (r, r);
    KernelSHAP
    f(x) and f(b) as one batch, then ceil(M / 16) batches of masked clips;
    LIME the ceil(M / 16) batches. K1 once per eligible conv layer and
    backward, the flash kernels once per encoder layer and pass."""
    ec, mc = cfg.explainer, cfg.model
    check(ec.kmeans_background == 0, "expected_launches_method: no k-means")
    layers, convs = mc.num_hidden_layers, len(k1_main_shapes(mc, 1))
    b, t_out, oc = ec.num_background, mc.frames_for_samples(N_SAMPLES), ec.output_chunk
    chunks = -(-t_out // oc) if 0 < oc < t_out else 1
    fwd, bwd = {"deep": (2 + 2 * b + (b * chunks if ec.remat else 0), b * chunks),
                "kernel": (2 + -(-ec.nsamples // CLIP_BATCH), 0),
                "lime": (1 + -(-ec.lime_num_samples // CLIP_BATCH), 0)}[ec.method]
    k1_, f, dq, dkv = path_kernels(mc)
    want = {f: samples * fwd * layers, k1_: samples * bwd * convs,
            dq: samples * bwd * layers, dkv: samples * bwd * layers}
    return {name: n for name, n in want.items() if n}


def explainer_inputs(test_set):
    """(x, background): the 5 dB clip, normalized, on the card, and
    DEEP_BACKGROUND rows of 0.01 N(0, 1) from a fixed seed (those of
    ``reference_draw``)."""
    x = zero_mean_unit_var(torch.from_numpy(test_set[1]["audio"]).cuda())
    bg = 0.01 * torch.randn((DEEP_BACKGROUND, N_SAMPLES),
                            generator=torch.Generator().manual_seed(1)).cuda()
    return x, bg


def dual_builder(mc: Wav2Vec2Config):
    return (w2v2_conformer_dual_fn if isinstance(mc, Wav2Vec2ConformerConfig)
            else wav2vec2_dual_fn)


def perturbation_explain(method: str, params, mc: Wav2Vec2Config, ec: ExplainerConfig,
                         x, baseline):
    """KernelSHAP or LIME at x with fixed coalitions (seed 3)."""
    f_batch = make_batched_fn(params, mc, ec)
    if method == "kernel":
        masks = sample_coalitions(torch.Generator().manual_seed(3), ec.kernel_num_segments,
                                  ec.nsamples)
        return kernel_shap_attributions(f_batch, x, num_segments=ec.kernel_num_segments,
                                        baseline=baseline, masks=masks)
    masks = lime_masks(torch.Generator().manual_seed(3), ec.lime_num_segments,
                       ec.lime_num_samples, ec.lime_keep_prob)
    return lime_attributions(f_batch, x, num_segments=ec.lime_num_segments,
                             keep_prob=ec.lime_keep_prob, ridge_alpha=ec.lime_ridge_alpha,
                             baseline=baseline, masks=masks)


def deep_gate(label: str, cfg: PipelineConfig, params, test_set) -> None:
    """DeepSHAP's phi against one background row through the kernels and
    through plain PyTorch on the card, within 2e-3 of max|phi|; the sum of
    phi over the samples against f(x) - f(r) per frame is logged."""
    mc, ec = cfg.model, cfg.explainer
    x, bg = explainer_inputs(test_set)
    plain = dataclasses.replace(mc, attention_impl="xla", conv_impl="lax")
    build = dual_builder(mc)
    out_k = deep_shap_values(build(params, mc, ec), x, bg[2:3], ec.output_chunk)
    out_p = deep_shap_values(build(params, plain, ec), x, bg[2:3], ec.output_chunk)
    scale = float(out_p.values.abs().max())
    err = compare(f"deep {label}: phi of one background row, kernels vs plain PyTorch",
                  out_k.values, out_p.values, 2e-3 * scale, 0.0,
                  f"2e-3 of max|phi|: float32 through {mc.num_hidden_layers} layers and the "
                  "rescale rules, another summation order in every product")
    gap = out_k.model_output - out_k.base_values
    miss = (out_k.values.sum(dim=0) - gap).abs()
    log(f"deep {label}: max_abs_err / max|phi| = {err / scale:.3e}; (information) "
        f"completeness: max_t |sum_n phi - (f(x) - f(r))| = {float(miss.max()):.4e} against "
        f"max_t |f(x) - f(r)| = {float(gap.abs().max()):.4e} (not exact: the norms and "
        "attention take their plain gradient)")


def perturbation_gate(label: str, method: str, cfg: PipelineConfig, params, test_set) -> None:
    """KernelSHAP or LIME with the same coalitions through the kernels and
    through plain PyTorch on the card: segment values, model output and the
    base value (LIME: intercept), each within 2e-3 of its max|.|."""
    mc, ec = cfg.model, cfg.explainer
    x, bg = explainer_inputs(test_set)
    plain = dataclasses.replace(mc, attention_impl="xla", conv_impl="lax")
    got = perturbation_explain(method, params, mc, ec, x, bg.mean(dim=0))
    want = perturbation_explain(method, params, plain, ec, x, bg.mean(dim=0))
    for field in ("segment_values", "model_output",
                  "base_value" if method == "kernel" else "intercept"):
        a, b = getattr(got, field), getattr(want, field)
        compare(f"{method} {label} {field} {tuple(b.shape)}, kernels vs plain PyTorch", a, b,
                2e-3 * float(b.abs().max()), 0.0,
                f"2e-3 of max|.|: float32 forwards of {CLIP_BATCH} clips per batch, another "
                "summation order, through the same least-squares solve")


def bf16_method_rule(label: str, method: str, cfg16: PipelineConfig, params, test_set) -> None:
    """phi of a method three ways, as ``phase_reference_bf16`` holds expected
    gradients: bf16 + "default" through the kernels, through plain PyTorch,
    and float32 + "highest" through the kernels (DeepSHAP against one
    background row, gated on the frames whose max head is defined at bf16;
    KernelSHAP and LIME with fixed coalitions, on every frame: they take the
    max head's values only, which move continuously)."""
    ec = cfg16.explainer
    x, bg = explainer_inputs(test_set)
    k16 = cfg16.model
    paths = {"k16": (k16, cast_params_for_compute(params, "bfloat16")),
             "p16": (dataclasses.replace(k16, attention_impl="xla", conv_impl="lax"),
                     cast_params_for_compute(params, "bfloat16")),
             "32": (dataclasses.replace(k16, dtype="float32", matmul_precision="highest"),
                    params)}
    phi, logits = {}, {}
    for key, (mc, p) in paths.items():
        with matmul_precision_scope(mc.matmul_precision):
            if method == "deep":
                phi[key] = deep_shap_values(dual_builder(mc)(p, mc, ec), x, bg[2:3],
                                            ec.output_chunk).values
            else:
                phi[key] = perturbation_explain(method, p, mc, ec, x, bg.mean(dim=0)).values
            with torch.no_grad():
                logits[key] = model_logits_fn(mc)(p, mc, x[None])[0]
        check(phi[key].dtype == torch.float32 and bool(torch.isfinite(phi[key]).all()),
              f"{label} {key}: phi {phi[key].dtype} not finite float32")
    frame_sets = [("all frames", slice(None))]
    if method == "deep":
        frame_sets.append(("defined frames", defined_frames(label, logits)))
    phi_rule(label, phi, frame_sets)


def time_method(label: str, cfg: PipelineConfig, params, test_set, smi: str) -> None:
    """Wall and device-busy ms of one explained sample (the clean clip,
    ``explain_phi`` with the pipeline's background), and its peak device
    memory: one run unprofiled, one under torch.profiler (its busy time
    against its own wall)."""
    from torch.profiler import ProfilerActivity, profile

    x = zero_mean_unit_var(torch.from_numpy(test_set[0]["audio"]).cuda())
    _, bg = explainer_inputs(test_set)
    run = lambda: explain_phi(params, cfg, x, bg, torch.Generator().manual_seed(4))  # noqa: E731
    with matmul_precision_scope(cfg.model.matmul_precision):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    busy_s = (f"{busy:.1f} ms ({100 * busy / prof_ms:.1f}% of the profiled wall "
              f"{prof_ms:.1f} ms)" if busy else "not measured")
    log(f"explainers time {label}: wall {wall_ms:.1f} ms per explained sample, device busy "
        f"{busy_s}, peak device memory {peak:.2f} GiB ({N_SAMPLES} samples; {smi})")


def flash_cost(kind: str, bh: int, n: int, t: int, d: int, dtype, full: bool):
    """(operations, bytes) of one launch of the flash forward ("fwd"), dq
    ("dq") or dk/dv ("dkv"): q, k, v, o, g, dq, dk, dv in the inputs' dtype,
    lse, dd, the full bias and d(bias) float32, each read or written once;
    the scores counted once per residual row (as ``flash_costs``)."""
    e = 2.0 if dtype == BF16 else 4.0
    tt = 4.0 * bh * t * t if full else 0.0
    if kind == "fwd":
        return 4.0 * bh * t * t * d, e * 4 * bh * t * d + 4.0 * bh * t + tt
    if kind == "dq":
        return (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                e * (2 * n * t * d + 4 * bh * t * d) + 4.0 * (n * t + bh * t) + tt
                + (4.0 * n * t * t if full else 0.0))
    return (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
            e * (3 * n * t * d + 3 * bh * t * d) + 4.0 * (n * t + bh * t) + tt)


def kernel_bound(fl: float, nb: float, dtype):
    return bound_bf16(fl, nb) if dtype == BF16 else bound_3xtf32(fl, nb)


def explainer_shapes_k1(gen, base: Wav2Vec2Config, dtype, n_samples: int = N_SAMPLES,
                        batch: int = 2, what: str = "DeepSHAP's dual batch",
                        tag: str = "explainers", rows: int = 0) -> None:
    """K1 at ``batch`` x T_out cotangent rows of ``n_samples``-sample clips
    (DeepSHAP's dual batch: 2 x 149; ``rows`` > 0: that many rows, as a
    training batch's one per clip) against its plain version at each
    eligible layer, then timed beside its bound and cuDNN's dgrad (per
    backward: one launch per layer)."""
    rows = rows or batch * base.frames_for_samples(n_samples)
    name = k1_name(dtype)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0.0, bytes=0.0)
    for k, s, ci, co, ti, to in k1_main_shapes(base, rows, n_samples):
        ybar, w = (x.to(dtype) for x in k1_inputs(gen, rows, k, ci, co, to))
        got = k1.conv1d_dgrad(ybar, w, s, ti)
        compare_bf16(f"{name} B={rows} ({what}) K={k} s={s} C={ci}x{co} "
                     f"T_out={to}", got, k1.conv1d_dgrad_plain(ybar, w, s, ti), 5e-4, 1e-4,
                     "K1's tolerance: 3xTF32 products summed in float32, another order")
        del got
        x_nct = torch.empty((rows, ci, ti), device="cuda", dtype=dtype)
        y_nct = ybar.transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()
        iters = 3 if to > 1000 else 10
        vals = dict(
            ms=time_ms(lambda: k1.conv1d_dgrad(ybar, w, s, ti), iters),
            plain_ms=time_ms(lambda: k1.conv1d_dgrad_plain(ybar, w, s, ti), iters),
            library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                y_nct, x_nct, w_oik, None, [s], [0], [1], False, [0], 1,
                [True, False, False]), iters))
        fl, nb = k1_cost(rows, k, s, ci, co, ti, to)
        vals.update(flops=fl, bytes=nb / 2 if dtype == BF16 else nb)
        for key, val in vals.items():
            tot[key] += val
        del ybar, w, x_nct, y_nct, w_oik
    b_ms, b_by = kernel_bound(tot["flops"], tot["bytes"], dtype)
    log(f"timing {tag} {name} B={rows} per backward: ms={tot['ms']:.4f} "
        f"plain_ms={tot['plain_ms']:.4f} library_ms(cuDNN dgrad)={tot['library_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by})")


def explainer_shapes_backward(gen, mc: Wav2Vec2Config, dtype, n_samples: int = N_SAMPLES,
                              batch: int = 2, tag: str = "explainers") -> None:
    """K3 and K4 (the conformer: K3b and K4f, with a rel-pos-like bias) at a
    residual batch of ``batch`` clips of ``n_samples`` with T_out cotangent
    rows per residual row (DeepSHAP's: 2 clips, 149 rows), against their
    plain versions and timed beside their bound and SDPA's backward on the
    same inputs."""
    shapes_backward(gen, mc.num_attention_heads, mc.head_dim, mc.frames_for_samples(n_samples),
                    isinstance(mc, Wav2Vec2ConformerConfig), dtype, batch, tag)


def shapes_backward(gen, h: int, d: int, t: int, full: bool, dtype, batch: int, tag: str,
                    with_device_ms: bool = False, rows: int = 0) -> None:
    """K3 and K4 (``full``: K3b and K4f, with a rel-pos-like bias) at ``h``
    heads of ``d``, ``t`` keys and a residual batch of ``batch`` clips with
    ``t`` cotangent rows per residual row (``rows`` > 0: that many; a
    training step has one), as ``explainer_shapes_backward``;
    ``with_device_ms`` adds each kernel's device time per launch and SDPA's
    backward's per call (torch.profiler, over windows of 100 and 50 calls:
    a window of a millisecond or two can lose its first device records)."""
    rows = rows or t
    q, k, v, _, g = (None if x is None else x.to(dtype)
                     for x in flash_inputs(gen, batch, h, t, d, rows, False))
    bias = rel_pos_bias(gen, q, False) if full else None
    bh, n = q.shape[0], g.shape[0]
    o, lse = fa.flash_fwd_plain(q, k, v, bias, h)
    dq_name, dkv_name = bwd_kernel_names(full, dtype)
    label = f"BH={bh} (residual batch {batch}) N={n} T={t}"
    why = f"float32 backward sums over {t} keys, another summation order"
    dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, h)
    dq_p, dd_p, dbias_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
    compare_bf16(f"{dq_name} dq {label}", dq, dq_p, 5e-5, 5e-4, why)
    compare_bf16(f"{dq_name} dd {label}", dd, dd_p, 5e-5, 5e-4, why)
    if full:
        compare(f"{dq_name} dbias {label}", dbias, dbias_p, 5e-5, 5e-4, why)
    del dq, dd, dbias, dq_p, dbias_p
    dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
    dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
    compare_bf16(f"{dkv_name} dk {label}", dk, dk_p, 5e-5, 5e-4, why)
    compare_bf16(f"{dkv_name} dv {label}", dv, dv_p, 5e-5, 5e-4, why)
    del dk, dv, dk_p, dv_p
    q4, k4, v4 = (x.reshape(batch, h, t, d) for x in (q, k, v))
    qe, ke, ve = (x.expand(rows, batch, h, t, d).reshape(rows * batch, h, t, d).contiguous()
                  .requires_grad_() for x in (q4, k4, v4))
    inputs, mask = (qe, ke, ve), None
    if full:
        mask = (bias.reshape(batch, h, t, t).expand(rows, batch, h, t, t)
                .reshape(rows * batch, h, t, t).to(dtype).contiguous().requires_grad_())
        inputs += (mask,)
    oe = F.scaled_dot_product_attention(qe, ke, ve, attn_mask=mask)
    g4 = g.reshape(rows * batch, h, t, d)
    sdpa_bwd = lambda: torch.autograd.grad(oe, inputs, g4, retain_graph=True)
    lib = time_ms(sdpa_bwd, 5)
    lib_dev = f" library_device_ms={device_ms_per_call(sdpa_bwd, 50):.4f}" if with_device_ms else ""
    del oe, qe, ke, ve, mask, inputs, sdpa_bwd
    kernel = "bf16" if dtype == BF16 else "mma"
    for name, kind, fn, pfn in (
        (dq_name, "dq", lambda: fa.flash_dq(q, k, v, o, lse, g, bias, h),
         lambda: fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)),
        (dkv_name, "dkv", lambda: fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h),
         lambda: fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)),
    ):
        ms, pms = time_ms(fn, 5), time_ms(pfn, 5)
        dev = (f" device_ms={device_ms(fn, f'flash_{kind}_{kernel}_kernel', 100):.4f}"
               if with_device_ms else "")
        b_ms, b_by = kernel_bound(*flash_cost(kind, bh, n, t, d, dtype, full), dtype)
        log(f"timing {tag} {name} {label}: ms={ms:.4f}{dev} plain_ms={pms:.4f} "
            f"library_ms(SDPA backward, same inputs)={lib:.4f}{lib_dev} bound_ms={b_ms:.4f} "
            f"({b_by})")
    del q, k, v, g, bias, o, lse, dd_p


def explainer_shapes_forward(gen, mc: Wav2Vec2Config, clips, dtype,
                             n_samples: int = N_SAMPLES, tag: str = "explainers") -> None:
    """K2 (the conformer: K2f, with a rel-pos-like bias) at batches of
    ``clips`` whole clips of ``n_samples`` (the perturbation explainers' and
    faithfulness's), against its plain version at both block heights, and
    timed beside its bound and SDPA's forward (K2's time is device time
    under torch.profiler, per launch)."""
    shapes_forward(gen, mc.num_attention_heads, mc.head_dim, mc.frames_for_samples(n_samples),
                   isinstance(mc, Wav2Vec2ConformerConfig), clips, dtype, tag)


def shapes_forward(gen, h: int, d: int, t: int, full: bool, clips, dtype, tag: str,
                   device_iters: int = 50) -> None:
    """K2 (``full``: K2f, with a rel-pos-like bias) at ``h`` heads of ``d``,
    ``t`` keys and batches of ``clips``, as ``explainer_shapes_forward``;
    the device times over windows of ``device_iters`` calls."""
    name = ("flash_fwd_bias" if full else "flash_fwd") + ("_bf16" if dtype == BF16 else "")
    kname = "flash_fwd_bf16_kernel" if dtype == BF16 else "flash_fwd_kernel"
    for b in clips:
        q, k, v, _, _ = (None if x is None else x.to(dtype)
                         for x in flash_inputs(gen, b, h, t, d, 1, False))
        bias = rel_pos_bias(gen, q, False) if full else None
        want = fa.flash_fwd_plain(q, k, v, bias, h)
        label = f"BH={b * h} ({b} clips) T={t}"
        fa._check(q, k, v, bias, h)
        for rows in fa.FWD_ROWS:
            got = fa._fwd_launch(q, k, v, bias, h, rows)
            for part, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                compare_bf16(f"{name} {part} {label} rows/block={rows}", x, y, 2e-5, 2e-4,
                             f"float32 softmax over {t} keys, another summation order")
        q4, k4, v4 = (x.reshape(b, h, t, d) for x in (q, k, v))
        mask = None if bias is None else bias.reshape(b, h, t, t).to(dtype)
        ms = time_ms(lambda: fa.flash_fwd(q, k, v, bias, h), 50)
        pms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, bias, h), 20)
        lms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), 50)
        dms = device_ms(lambda: fa.flash_fwd(q, k, v, bias, h), kname, device_iters)
        sdpa_dms = device_ms_per_call(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), device_iters)
        b_ms, b_by = kernel_bound(*flash_cost("fwd", b * h, b * h, t, d, dtype, full), dtype)
        log(f"timing {tag} {name} {label} rows/block={fa.fwd_block_rows(q)}: ms={ms:.4f} "
            f"device_ms={dms:.5f} plain_ms={pms:.4f} library_ms(SDPA forward)={lms:.4f} "
            f"library_device_ms={sdpa_dms:.5f} bound_ms={b_ms:.5f} ({b_by}); device time "
            f"K2/SDPA {dms / sdpa_dms:.3f}")
        del q, k, v, bias, want, q4, k4, v4, mask


def phase_explainer_shapes(base: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig) -> None:
    """Every kernel at the shapes the explainers give it, in float32 and in
    bf16: K1 at 2 x 149 rows; K3/K4 and K3b/K4f at a residual batch of 2;
    K2 at 16 and 21 clips (BH = 192, 252), K2f at 16 clips (BH = 256)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for dtype in (torch.float32, BF16):
        explainer_shapes_k1(gen, base, dtype)
        explainer_shapes_backward(gen, base, dtype)
        explainer_shapes_backward(gen, conformer, dtype)
        explainer_shapes_forward(gen, base, (CLIP_BATCH, 21), dtype)
        explainer_shapes_forward(gen, conformer, (CLIP_BATCH,), dtype)


def method_pipeline(label: str, cfg: PipelineConfig, params, test_set) -> dict:
    """``phase_pipeline`` for the deep, kernel or lime method, with the exact
    launch counts of ``expected_launches_method`` and no other kernel."""
    path = path_kernels(cfg.model)
    expect = path if cfg.explainer.method == "deep" else path[1:2]
    launches = phase_pipeline(label, cfg, params, test_set, expect)
    want = expected_launches_method(cfg, len(test_set))
    got = {name: n for name, n in launches.items() if n}
    check(got == want, f"{label}: launches {got}, {want} expected")
    log(f"{label}: launch counts exact {json.dumps(want)}")
    return launches


def phase_cli_explainers(archive: str, data_dir: str) -> None:
    """run-shap --method deep, kernel and lime, then faithfulness over each
    store, on the trained conformer archive switched to the kernels (3 heads
    of 32), on the card and on the CPU: phi within 2e-3 of max|phi|, and the
    faithfulness command on the card and on the CPU over the card's store
    gives the same records. On the card each command launches the path's
    kernels the code says, and no other."""
    cfg = load_config(archive)
    common = ["--params", archive, "--arch", "w2v2-conformer"]
    n_args = dict(zip(EXPLAINER_CLI_ARGS[::2], EXPLAINER_CLI_ARGS[1::2]))
    for method in METHODS:
        stores = {}
        for device in ("cuda", "cpu"):
            d = stores[device] = f"{data_dir}/cli_{method}_{device}"
            (run,), launches, wall = run_cli(
                f"explainers {method} {device}",
                ["run-shap", *common, "--device", device, "--data-dir", d, "--method", method,
                 *EXPLAINER_CLI_ARGS])
            log(f"cli explainers {method} {device}: {wall / run['computed']:.3f} s per sample")
            if device == "cuda":
                ec = ExplainerConfig(method=method, output_chunk=128,  # run-shap's default
                                     num_background=int(n_args["--num-background"]),
                                     nsamples=int(n_args["--nsamples"]),
                                     lime_num_samples=int(n_args["--nsamples"]))
                want = expected_launches_method(PipelineConfig(model=cfg, explainer=ec),
                                                run["computed"])
                check(launches == want, f"cli explainers {method}: run-shap launched "
                      f"{launches}, {want} expected")
        store = AttributionStore(stores["cuda"])
        for key in store.keys():
            got = torch.from_numpy(store.load(key)["shap_values"])
            want_phi = torch.from_numpy(AttributionStore(stores["cpu"]).load(key)["shap_values"])
            compare(f"cli explainers {method} phi {key.index} {key.type}, card vs CPU", got,
                    want_phi, 2e-3 * float(want_phi.abs().max()), 0.0,
                    "2e-3 of max|phi|: float32, another summation order on each device")
        records = {}
        for device in ("cuda", "cpu"):
            records[device], launches, _ = run_cli(
                f"explainers faithfulness {method} {device}",
                ["faithfulness", *common, "--device", device, "--data-dir", stores["cuda"]])
            if device == "cuda":
                fwd = path_kernels(cfg)[1]
                check(launches == {fwd: cfg.num_hidden_layers * (len(records["cuda"]) - 1)},
                      f"cli explainers faithfulness {method}: launched {launches}")
        check(records["cuda"] == records["cpu"],
              f"cli explainers faithfulness {method}: card and CPU records differ")
        log(f"faithfulness {method} (conformer archive, card = CPU): "
            f"{json.dumps(records['cuda'][-1])}")


def phase_explainers(model: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig,
                     explainer: ExplainerConfig, test_set, data_dir: str, smi: str) -> None:
    """DeepSHAP, KernelSHAP and LIME: the kernels at the explainers' shapes;
    each method through run_shap_pipeline at full width with exact launch
    counts, in float32 (DeepSHAP also on the conformer) and in bf16, each
    gated against plain PyTorch on the card; their times; and the command
    line (run-shap --method, faithfulness) on the card and the CPU."""
    phase_explainer_shapes(model, conformer)
    params = init_wav2vec2_params(SEED, model, device="cuda")
    model16 = dataclasses.replace(model, dtype="bfloat16", matmul_precision="default")
    for method in METHODS:
        ec = method_config(explainer, method)
        cfg = PipelineConfig(model=model, explainer=ec, seed=SEED,
                             data_dir=f"{data_dir}/explain_{method}")
        method_pipeline(f"pipeline {method} base", cfg, params, test_set)
        if method == "deep":
            deep_gate("base", cfg, params, test_set)
        else:
            perturbation_gate("base", method, cfg, params, test_set)
        time_method(f"{method} base float32", cfg, params, test_set, smi)
        cfg16 = PipelineConfig(model=model16, explainer=ec, seed=SEED,
                               data_dir=f"{data_dir}/explain_{method}_bf16")
        method_pipeline(f"pipeline {method} bf16", cfg16, params, test_set)
        bf16_method_rule(f"phi bf16 {method}", method, cfg16, params, test_set)
        time_method(f"{method} base bf16", cfg16, cast_params_for_compute(params, "bfloat16"),
                    test_set, smi)
    del params
    cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
    cfg = PipelineConfig(model=conformer, explainer=method_config(explainer, "deep"),
                         seed=SEED, data_dir=f"{data_dir}/explain_deep_conformer")
    method_pipeline("pipeline deep conformer", cfg, cparams, test_set)
    deep_gate("conformer", cfg, cparams, test_set)
    time_method("deep conformer float32", cfg, cparams, test_set, smi)
    del cparams
    phase_cli_explainers(archive_with_kernels(CONFORMER_ARCHIVE,
                                              f"{data_dir}/conformer_explainers.npz"),
                         data_dir)

# ---------------------------------------------------------------- compare and visualize

# compare's default window (2 s at 16 kHz: T_out = 99 on the full conv
# stack), and the gate's explicit expected-gradients draws and LIME masks
COMPARE_SAMPLES = 32_000
GATE_DRAWS, GATE_MASKS = 4, 64
# compare's defaults (asr_shap/cli.py: --nsamples 200, --lime-samples 500),
# and the conformer archive's run on the card and the CPU
DEFAULT_DRAWS, DEFAULT_MASKS = 200, 500
CONFORMER_DRAWS, CONFORMER_MASKS = 8, 64


def has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def compare_launches(mc: Wav2Vec2Config, ec: ExplainerConfig, masks: int) -> dict:
    """Launches of each kernel in one lime_shap_comparison of a
    COMPARE_SAMPLES clip, counted from the code: expected gradients as
    ``expected_launches_eg`` with no transcript forward (one backward call
    per chunk of ``draw_chunk`` draws: output_chunk 0), then LIME's ceil(masks
    / 16) forwards of 16 clips."""
    want = expected_launches_eg(PipelineConfig(model=mc, explainer=ec), 1, COMPARE_SAMPLES,
                                transcripts=0)
    fwd = path_kernels(mc)[1]
    want[fwd] = want.get(fwd, 0) + -(-masks // CLIP_BATCH) * mc.num_hidden_layers
    return want


@contextlib.contextmanager
def captured_comparisons():
    """The results of each lime_shap_comparison the compare command makes
    inside the block (the command prints only their scalar record)."""
    inner, results = compare_mod.lime_shap_comparison, []

    def capture(*args, **kw):
        results.append(inner(*args, **kw))
        return results[-1]

    compare_mod.lime_shap_comparison = capture
    try:
        yield results
    finally:
        compare_mod.lime_shap_comparison = inner


def compare_shapes(base: Wav2Vec2Config, archive: Wav2Vec2ConformerConfig) -> None:
    """Every kernel at the shapes compare gives it, in float32 and bf16,
    against its plain version and timed ("timing compare" lines): K1 at the
    EG backward's 99 cotangent rows; K3/K4 at one residual clip with 99 rows;
    K2 at one clip (the EG forward, BH = 12) and at LIME's 16 (BH = 192); and
    K3b/K4f, K2f at the trained conformer archive's 3 heads of 32, the same
    batches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for dtype in (torch.float32, BF16):
        explainer_shapes_k1(gen, base, dtype, COMPARE_SAMPLES, 1, "compare's EG backward",
                            "compare")
        for mc in (base, archive):
            explainer_shapes_backward(gen, mc, dtype, COMPARE_SAMPLES, 1, "compare")
            explainer_shapes_forward(gen, mc, (1, CLIP_BATCH), dtype, COMPARE_SAMPLES,
                                     "compare")


def compare_gate(model: Wav2Vec2Config, params, clip: np.ndarray) -> None:
    """lime_shap_comparison at full width through the kernels and through
    plain PyTorch on the card, with GATE_DRAWS explicit draws, GATE_MASKS
    explicit LIME masks and one background: shap_matrix and lime_per_sample
    within 2e-3 of max|.|, both r's within 1e-3, and the kernels' exact
    launch counts (none on the plain run)."""
    ec = ExplainerConfig(nsamples=GATE_DRAWS, draw_chunk=1, lime_num_samples=GATE_MASKS)
    draws = sample_draws(torch.Generator().manual_seed(5), GATE_DRAWS, ec.num_background)
    masks = lime_masks(torch.Generator().manual_seed(6), ec.lime_num_segments, GATE_MASKS)
    bg = zeros_noise_background(torch.Generator().manual_seed(7), COMPARE_SAMPLES,
                                ec.num_background, ec.background_sigma, device="cuda")
    plain = dataclasses.replace(model, attention_impl="xla", conv_impl="lax")
    out, launches = {}, {}
    for label, mc in (("kernels", model), ("plain", plain)):
        reset_launches()
        out[label] = compare_mod.lime_shap_comparison(
            params, mc, ec, clip, seed=SEED, clip_seconds=COMPARE_SAMPLES / 16_000,
            background=bg, draws=draws, masks=masks)
        launches[label] = {name: c for name, c in LAUNCHES.items() if c}
    want = compare_launches(model, ec, GATE_MASKS)
    check(launches["kernels"] == want,
          f"compare gate: launches {launches['kernels']}, {want} expected")
    check(not launches["plain"], f"compare gate: the plain run launched {launches['plain']}")
    log(f"compare gate: launch counts exact {json.dumps(want)}")
    got, ref = out["kernels"], out["plain"]
    check(got["shap_matrix"].shape == (COMPARE_SAMPLES, model.frames_for_samples(
        COMPARE_SAMPLES)), f"compare gate: phi {got['shap_matrix'].shape}")
    for field in ("shap_matrix", "lime_per_sample"):
        a, b = torch.from_numpy(got[field]), torch.from_numpy(ref[field])
        scale = float(b.abs().max())
        err = compare(f"compare gate {field} {tuple(b.shape)}, kernels vs plain PyTorch", a, b,
                      2e-3 * scale, 0.0, f"2e-3 of max|.|: float32 through "
                      f"{model.num_hidden_layers} layers, another summation order")
        log(f"compare gate {field}: max_abs_err / max|.| = {err / scale:.3e}")
    for field in ("pearson_r", "pearson_r_segments"):
        check(abs(got[field] - ref[field]) <= 1e-3,
              f"compare gate {field}: {got[field]} vs plain {ref[field]} (limit 1e-3)")
        log(f"compare gate {field}: kernels {got[field]:.6f}, plain {ref[field]:.6f}")


def compare_defaults(base_archive: str, data_dir: str, clip: np.ndarray, mpl: bool,
                     smi: str) -> dict:
    """The compare command at the reference's defaults (200 draws, 500 LIME
    perturbations, 2 s) on the base archive, float32 "highest" and bf16
    "default": phi finite [32000, 99], the exact launch counts of the
    archive's kernels and no other (in bf16 only bf16 kernels), the walls
    and peak memory; then 4 more of its draws under torch.profiler (device
    busy share, time by kernel group). With matplotlib it writes its
    artifacts, else ``--out-dir ''``. Returns the float32 run's result."""
    archives = {"float32": base_archive,
                "bf16": archive_with_kernels(base_archive, f"{data_dir}/base_bf16.npz",
                                             dtype="bfloat16", matmul_precision="default")}
    results = {}
    for label, archive in archives.items():
        out_dir = f"{data_dir}/compare_{label}" if mpl else ""
        torch.cuda.reset_peak_memory_stats()
        with captured_comparisons() as runs:
            (rec,), launches, wall = run_cli(f"compare {label}", [
                "compare", "--params", archive, "--out-dir", out_dir])
        peak = torch.cuda.max_memory_allocated() / 2**30
        (res,) = runs
        cfg = load_config(archive)
        phi = res["shap_matrix"]
        check(phi.shape == (COMPARE_SAMPLES, cfg.frames_for_samples(COMPARE_SAMPLES))
              and bool(np.isfinite(phi).all()) and bool(np.isfinite(res["lime_per_sample"]).all()),
              f"compare {label}: phi {phi.shape} not finite [32000, 99]")
        want = compare_launches(cfg, ExplainerConfig(nsamples=DEFAULT_DRAWS), DEFAULT_MASKS)
        check(launches == want, f"compare {label}: launched {launches}, {want} expected")
        if mpl:
            check(all(Path(rec[k]).exists() for k in ("figure", "shap_wav", "lime_wav", "stats")),
                  f"compare {label}: artifacts missing")
        log(f"compare time {label}: shap_wall_s={rec['shap_wall_s']} ({DEFAULT_DRAWS} draws, "
            f"{rec['shap_wall_s'] / DEFAULT_DRAWS * 1e3:.1f} ms per draw), lime_wall_s="
            f"{rec['lime_wall_s']} ({DEFAULT_MASKS} perturbations), command {wall:.2f} s, peak "
            f"device memory {peak:.2f} GiB, pearson_r={rec['pearson_r']}, pearson_r_segments="
            f"{rec['pearson_r_segments']}; launch counts exact; {smi}")
        results[label] = res
        params = cast_params_for_compute(load_params(archive, device="cuda"), cfg.dtype)
        ec = ExplainerConfig(aggregation="mean", draw_chunk=1)
        x = zero_mean_unit_var(torch.from_numpy(clip).cuda())
        bg = zeros_noise_background(generator(SEED, 0), COMPARE_SAMPLES, ec.num_background,
                                    ec.background_sigma, device="cuda")
        log(f"compare profile {label}: EG draws of the compare command's explained function")
        with matmul_precision_scope(cfg.matmul_precision):
            profile_draws(make_explained_fn(params, cfg, ec), x, bg, ec, n=4)
        del params
    return results["float32"]


def compare_artifacts(res: dict, clip: np.ndarray, data_dir: str) -> None:
    """The two wavs of compare's artifact path from the card's phi and LIME
    values (amplified_pair, write_wav), against the CPU's amplification of
    the same arrays within 1e-6 (float32 means over 99 frames in another
    order), and read back within one 16-bit step."""
    c, phi = torch.from_numpy(clip), torch.from_numpy(res["shap_matrix"])
    lime = torch.from_numpy(res["lime_per_sample"][:, None])
    card = amplified_pair(c.cuda(), phi.cuda(), lime.cuda())
    cpu = amplified_pair(c, phi, lime)
    for name, a, b in zip(("shap", "lime"), card, cpu):
        compare(f"compare artifacts {name} amplified, card vs CPU", torch.from_numpy(a),
                torch.from_numpy(b), 1e-6, 0.0, "float32 mean over the frames, another order")
        path = f"{data_dir}/compare_{name}_amplified.wav"
        write_wav(path, a)
        back, sr = read_wav(path)
        check(sr == 16_000 and back.shape == a.shape
              and float(np.abs(back - np.clip(a, -1, 1)).max()) <= 1 / 32767,
              f"compare artifacts {name}: the wav read back differs")
    log("compare artifacts: both wavs from the card's phi equal the CPU's, read back")


def compare_conformer(data_dir: str) -> None:
    """compare --arch w2v2-conformer on the trained conformer archive
    switched to the kernels, on the card and the CPU: phi and LIME within
    2e-3 of max|.|, the same record keys, and on the card the exact launch
    counts of its kernels (K2f, K3b, K4f; its 48 conv channels take no K1)."""
    archive = archive_with_kernels(CONFORMER_ARCHIVE, f"{data_dir}/conformer_compare.npz")
    res, recs, launches = {}, {}, {}
    for device in ("cuda", "cpu"):
        with captured_comparisons() as runs:
            (recs[device],), launches[device], wall = run_cli(f"compare conformer {device}", [
                "compare", "--params", archive, "--arch", "w2v2-conformer", "--device", device,
                "--nsamples", str(CONFORMER_DRAWS), "--lime-samples", str(CONFORMER_MASKS),
                "--out-dir", ""])
        (res[device],) = runs
    want = compare_launches(load_config(archive), ExplainerConfig(nsamples=CONFORMER_DRAWS),
                            CONFORMER_MASKS)
    check(launches["cuda"] == want,
          f"compare conformer: launched {launches['cuda']}, {want} expected")
    check(set(recs["cuda"]) == set(recs["cpu"]), "compare conformer: record keys differ")
    for field in ("shap_matrix", "lime_per_sample"):
        a, b = (torch.from_numpy(res[d][field]) for d in ("cuda", "cpu"))
        compare(f"compare conformer {field} {tuple(b.shape)}, card vs CPU", a, b,
                2e-3 * float(b.abs().max()), 0.0,
                "2e-3 of max|.|: float32, another summation order on each device")
    log(f"compare conformer (card = CPU): launch counts exact {json.dumps(want)}; card "
        f"{json.dumps(recs['cuda'])}")


def visualize_on_card(data_dir: str) -> None:
    """visualize's view (load_attribution_view) of the first sample of the
    trained study archive's store (phase 5's) on the card and on the CPU:
    the same transcription, display tokens and character frames, masks and
    masked audios within 1e-4 (the same percentile rule on float32 block
    means summed in another order), and one flash_fwd launch per encoder
    layer, no other."""
    archive = f"{data_dir}/study_pallas.npz"
    store = AttributionStore(f"{data_dir}/cli_study")
    data = store.load(store.keys()[0])
    cfg = load_config(archive)
    views = {}
    for device in ("cuda", "cpu"):
        params = load_params(archive, device=device)
        reset_launches()
        views[device] = load_attribution_view(params, cfg, np.asarray(data["audio"]),
                                              np.asarray(data["shap_values"]))
        if device == "cuda":
            torch.cuda.synchronize()
            launches = {name: c for name, c in LAUNCHES.items() if c}
    check(launches == {"flash_fwd": cfg.num_hidden_layers},
          f"visualize: launched {launches}, {cfg.num_hidden_layers} flash_fwd expected")
    card, cpu = views["cuda"], views["cpu"]
    for field in ("transcription", "display_tokens", "char_frames"):
        check(getattr(card, field) == getattr(cpu, field), f"visualize: {field} differs")
    for field in ("masks", "masked_audios"):
        compare(f"visualize {field} {getattr(cpu, field).shape}, card vs CPU",
                torch.from_numpy(getattr(card, field)), torch.from_numpy(getattr(cpu, field)),
                1e-4, 0.0, "the same percentile rule on float32 block means in another order")
    log(f"visualize (card = CPU): {len(card.char_frames)} characters of "
        f"{card.transcription!r}; {cfg.num_hidden_layers} flash_fwd launches")


def mel_on_card(clip: np.ndarray) -> None:
    """log_mel_spectrogram ("db", "natural", "none") and mel_to_audio (32
    Griffin-Lim iterations) of the 32,000-sample clip on the card against
    the CPU, each timed with CUDA events."""
    x = torch.from_numpy(clip)
    xc = x.cuda()
    for log_kind, atol, why in (("db", 1e-2, "1e-2 dB absolute (0.23% of the power)"),
                                ("natural", 2.3e-3, "2.3e-3 absolute on ln (0.23%)"),
                                ("none", None, "1e-5 of max|mel|")):
        want = log_mel_spectrogram(x, log=log_kind)
        got = log_mel_spectrogram(xc, log=log_kind)
        compare(f"mel {log_kind} {tuple(want.shape)}, card vs CPU", got.cpu(), want,
                atol if atol is not None else 1e-5 * float(want.abs().max()), 0.0,
                f"{why}: float32 rFFTs and mel products in another order")
        ms = time_ms(lambda: log_mel_spectrogram(xc, log=log_kind), 20)
        log(f"timing mel {log_kind}: {ms:.4f} ms per {COMPARE_SAMPLES}-sample clip")
    power = log_mel_spectrogram(x, log="none")
    want = mel_to_audio(power, length=COMPARE_SAMPLES)
    pc = power.cuda()
    got = mel_to_audio(pc, length=COMPARE_SAMPLES).cpu()
    rel = float((got - want).norm() / want.norm())
    log(f"check griffin-lim (mel_to_audio, 32 iterations) card vs CPU: relative L2 {rel:.3e} "
        "(limit 1e-3: float32 FFTs in another order, through 32 phase normalisations)")
    check(bool(torch.isfinite(got).all()) and rel <= 1e-3, "griffin-lim: card differs from CPU")
    ms = time_ms(lambda: mel_to_audio(pc, length=COMPARE_SAMPLES), 3)
    log(f"timing griffin-lim: {ms:.3f} ms per {COMPARE_SAMPLES}-sample clip (32 iterations)")


def drawing_commands(base_archive: str, data_dir: str, mpl: bool) -> None:
    """Each command asked to draw. Without matplotlib: it raises ImportError
    before any work, with no launch and no file made. With it: its figure is
    written."""
    study, store = f"{data_dir}/study_pallas.npz", f"{data_dir}/cli_study"
    fig = f"{data_dir}/figures"
    commands = {
        "sweep --plot": ["sweep", "--params", study, "--data-dir", store,
                         "--plot", f"{fig}/scatter.png"],
        "faithfulness --plot": ["faithfulness", "--params", study, "--data-dir", store,
                                "--limit", "1", "--plot", f"{fig}/curves.png"],
        "bench --plot": ["bench", "--attn", "pallas", "--lengths", "16000", "--nsamples", "2",
                         "--plot", f"{fig}/runtime.png"],
        "compare --out-dir": ["compare", "--params", base_archive, "--nsamples", "8",
                              "--lime-samples", "16", "--out-dir", f"{fig}/compare"],
        "visualize --save": ["visualize", "--params", study, "--data-dir", store,
                             "--save", f"{fig}/view.png"],
    }
    for label, argv in commands.items():
        target = Path(argv[-1])
        if mpl:
            run_cli(f"drawing {label}", argv)
            check(target.exists(), f"drawing {label}: {target} not written")
            continue
        reset_launches()
        try:
            cli.main(argv)
        except ImportError as e:
            msg = str(e)
        else:
            raise CheckFailed(f"drawing {label}: ran without matplotlib")
        check(not any(LAUNCHES.values()), f"drawing {label}: launched {dict(LAUNCHES)}")
        check(not target.exists() and not Path(fig).exists(), f"drawing {label}: wrote a file")
        log(f"drawing {label}: refused before any work (no launch, no file): {msg}")


def phase_compare(model: Wav2Vec2Config, base_archive: str, data_dir: str, smi: str) -> None:
    """The compare and visualize commands: the kernels at compare's shapes;
    the comparison gated against plain PyTorch; compare at its defaults in
    float32 and bf16; its wavs; the conformer archive on the card and the
    CPU; visualize's view on the card and the CPU; the mel front end and
    Griffin-Lim; the drawing commands."""
    t0 = time.perf_counter()
    clip = synthetic_speech(generator(SEED), COMPARE_SAMPLES)  # compare's own clip
    compare_shapes(model, load_config(CONFORMER_ARCHIVE))
    params = init_wav2vec2_params(SEED, model, device="cuda")
    compare_gate(model, params, clip)
    del params
    mpl = has_matplotlib()
    log(f"compare: matplotlib {'imports' if mpl else 'does not import'} here")
    f32 = compare_defaults(base_archive, data_dir, clip, mpl, smi)
    compare_artifacts(f32, clip, data_dir)
    compare_conformer(data_dir)
    visualize_on_card(data_dir)
    mel_on_card(clip)
    drawing_commands(base_archive, data_dir, mpl)
    log(f"compare phase: {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ mel conformer

# a synthetic 128-piece BPE vocab (the blank is index 128, after it)
NEMO_VOCAB = tuple(("▁" if i % 3 == 0 else "") + f"p{i}" for i in range(128))
NEMO_KERNELS = ("flash_fwd_bias", "flash_dq_dbias", "flash_dkv_bias")
MEL_CONFORMER_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def mel_features(audio: torch.Tensor) -> torch.Tensor:
    """[..., N] samples -> [..., T, 80] log-mel features (32 ms window, 10 ms
    hop, natural log) with the per-feature normalisation over time of
    scripts/pin_checkpoints.py (population std)."""
    mel = log_mel_spectrogram(audio, n_fft=512, hop_length=160, n_mels=80, log="natural")
    mean = mel.mean(dim=-2, keepdim=True)
    return (mel - mean) / (mel.std(dim=-2, keepdim=True, correction=0) + 1e-5)


def mel_inputs(test_set, num_background: int):
    """(features of both clips [2, 301, 80], the explained clip's flattened
    [24,080] (the 5 dB mix), background [num_background, 24,080]: the
    features of seeded white-noise clips)."""
    audio = torch.from_numpy(np.stack([s["audio"] for s in test_set])).cuda()
    feats = mel_features(audio)
    noise = 0.01 * torch.randn((num_background, N_SAMPLES),
                               generator=torch.Generator().manual_seed(SEED + 21)).cuda()
    return feats, feats[1].reshape(-1), mel_features(noise).reshape(num_background, -1)


def randomize_affines(params, seed: int) -> None:
    """Seeded values in place of the init's zero u/v biases, identity
    BatchNorm statistics and unit norms, so that the bias path and every
    converted key carry information: each norm's scale in [0.5, 1.5], every
    bias in [-0.1, 0.1], BatchNorm mean in [-0.2, 0.2] and var in [0.5,
    1.5], u and v in [-0.5, 0.5]."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(t, lo, hi):
        t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=gen, device="cuda"))

    def walk(node):
        if isinstance(node, list):
            for x in node:
                walk(x)
            return
        for key, val in node.items():
            if isinstance(val, (dict, list)):
                walk(val)
            elif key == "scale" or key == "var":
                fill(val, 0.5, 1.5)
            elif key == "bias":
                fill(val, -0.1, 0.1)
            elif key == "mean":
                fill(val, -0.2, 0.2)
            elif key in ("bias_u", "bias_v"):
                fill(val, -0.5, 0.5)

    walk(params)


def nemo_state_dict(params) -> dict:
    """The port's NeMo params keyed as NeMo's EncDecCTCModelBPE state_dict
    (ConformerEncoder, ConvASRDecoder): the inverse of
    ``models/nemo_ctc.py::convert_nemo_state_dict``, on the host."""
    sd = {}

    def put(key, t):
        sd[key] = t.detach().cpu().contiguous()

    def lin(prefix, p):
        put(f"{prefix}.weight", p["kernel"].T)
        put(f"{prefix}.bias", p["bias"])

    def pointwise(prefix, p):
        put(f"{prefix}.weight", p["kernel"].T[:, :, None])
        put(f"{prefix}.bias", p["bias"])

    def norm(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    for i, conv in enumerate(params["subsampling"]["convs"]):
        put(f"encoder.pre_encode.conv.{2 * i}.weight", conv["kernel"].permute(3, 2, 0, 1))
        put(f"encoder.pre_encode.conv.{2 * i}.bias", conv["bias"])
    lin("encoder.pre_encode.out", params["subsampling"]["out"])
    for li, layer in enumerate(params["layers"]):
        pre = f"encoder.layers.{li}"
        for nemo, ours in (("norm_feed_forward1", layer["ffn1"]["norm"]),
                           ("norm_self_att", layer["attn"]["norm"]),
                           ("norm_conv", layer["conv"]["norm"]),
                           ("norm_feed_forward2", layer["ffn2"]["norm"]),
                           ("norm_out", layer["final_norm"])):
            norm(f"{pre}.{nemo}", ours)
        for ff in ("1", "2"):
            lin(f"{pre}.feed_forward{ff}.linear1", layer[f"ffn{ff}"]["in"])
            lin(f"{pre}.feed_forward{ff}.linear2", layer[f"ffn{ff}"]["out"])
        a = layer["attn"]
        for name in ("q", "k", "v", "out"):
            lin(f"{pre}.self_attn.linear_{name}", a[name])
        put(f"{pre}.self_attn.linear_pos.weight", a["pos"]["kernel"].T)
        put(f"{pre}.self_attn.pos_bias_u", a["bias_u"])
        put(f"{pre}.self_attn.pos_bias_v", a["bias_v"])
        c = layer["conv"]
        pointwise(f"{pre}.conv.pointwise_conv1", c["pointwise1"])
        pointwise(f"{pre}.conv.pointwise_conv2", c["pointwise2"])
        put(f"{pre}.conv.depthwise_conv.weight", c["depthwise"]["kernel"].permute(2, 1, 0))
        put(f"{pre}.conv.depthwise_conv.bias", c["depthwise"]["bias"])
        for nemo, ours in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                           ("running_var", "var")):
            put(f"{pre}.conv.batch_norm.{nemo}", c["bn"][ours])
        sd[f"{pre}.conv.batch_norm.num_batches_tracked"] = torch.tensor(0)
    pointwise("decoder.decoder_layers.0", params["head"])
    return sd


def mel_explained_fn(logits_fn, params, cfg, ec: ExplainerConfig, frames: int):
    """f: flattened features [frames * input_dim] -> the explained outputs of
    each output frame (the max head over the vocab), each encoder layer
    recomputed in the backward when ``ec.remat``."""
    return lambda a: aggregation_head(logits_fn(params, cfg, a.reshape(frames, cfg.input_dim),
                                                remat=ec.remat), ec.aggregation)


def mel_eg_passes(ec: ExplainerConfig, t_out: int) -> tuple:
    """(flash forward passes, backward calls) of ``mel_eg``'s run over each
    encoder layer: f(x) and the base value (one vmapped forward), then per
    draw chunk ``eg_passes``' forward passes and backward calls."""
    chunks, calls, passes = eg_passes(ec, t_out)
    return 2 + chunks * passes, chunks * calls


def mel_eg(label: str, f, x, bg, ec: ExplainerConfig, draws, expect: dict):
    """expected_gradients (the user's call) at x with explicit draws, the
    launch counts set to 0 just before and read just after: they must be
    ``expect`` exactly. Logs the run's wall and peak device memory; returns
    (phi [N, T_out], the counts)."""
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = expected_gradients(f, x, bg, config=ec, draws=draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c for k, c in LAUNCHES.items() if c}
    log(f"mel {label}: expected_gradients, {draws[0].numel()} draws and 2 forwards for "
        f"f(x) and the base value (one vmapped forward of the {bg.shape[0]} background rows), wall {wall:.3f} s; launches {json.dumps(got)}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(got == expect, f"mel {label}: launches {got}, expected {expect}")
    phi = res.values
    check(bool(torch.isfinite(phi).all()), f"mel {label}: phi not finite")
    return phi, got


def mel_draw_wall(label: str, f, x, bg, ec: ExplainerConfig, n: int = 2) -> dict:
    """Wall per draw of ``n`` more draws (expected_phi, unprofiled), then
    ``profile_draws``: device busy per draw and time by kernel group."""
    ec = dataclasses.replace(ec, nsamples=n)
    draws = sample_draws(torch.Generator().manual_seed(SEED + 22), n, ec.num_background)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    expected_phi(f, x, bg, config=ec, draws=draws)
    torch.cuda.synchronize()
    log(f"mel {label}: wall per draw {(time.perf_counter() - t0) * 1e3 / n:.1f} ms ({n} draws)")
    return profile_draws(f, x, bg, ec, n)


def gate_phi(label: str, got, want, what: str) -> None:
    scale = float(want.abs().max())
    err = compare(f"mel {label}: {what}, kernels vs the plain twin", got, want, 2e-3 * scale,
                  0.0, "2e-3 of max|phi|: float32 through every layer, another summation "
                  "order in every product")
    log(f"mel {label}: max_abs_err / max|phi| = {err / scale:.3e} (max|phi| {scale:.4e})")


def nemo_float32(cfg, params, feats, x, bg, ec, draws) -> dict:
    """NeMo large in float32: logits and transcripts of both clips against
    the plain twin, EG through K2f/K3b/K4f with exact launches against the
    plain twin, wall, profile; the converter at full width."""
    label = "nemo float32"
    plain = dataclasses.replace(cfg, attention_impl="xla")
    t_out = cfg.subsampled_length(feats.shape[1])
    with torch.no_grad():
        reset_launches()
        lk = nemo_ctc_logits(params, cfg, feats)
        check(LAUNCHES["flash_fwd_bias"] == cfg.num_layers, f"{label}: forward launches")
        lp = nemo_ctc_logits(params, plain, feats)
    check(tuple(lk.shape) == (2, t_out, 129), f"{label}: logits {tuple(lk.shape)}")
    scale = float(lp.abs().max())
    compare(f"mel {label}: logits of both clips [2, {t_out}, 129]", lk, lp, 2e-3 * scale, 0.0,
            "2e-3 of max|logits|, float32 through 17 layers")
    tk, tp = nemo_ctc_decode(lk, NEMO_VOCAB), nemo_ctc_decode(lp, NEMO_VOCAB)
    log(f"mel {label}: transcripts {[s[:60] for s in tk]} (of {[len(s) for s in tk]} characters)")
    check(tk == tp, f"{label}: transcripts differ from the plain twin's")

    f = mel_explained_fn(nemo_ctc_logits, params, cfg, ec, feats.shape[1])
    fwd, bwd = mel_eg_passes(ec, t_out)
    expect = {"flash_fwd_bias": fwd * cfg.num_layers,
              "flash_dq_dbias": bwd * cfg.num_layers, "flash_dkv_bias": bwd * cfg.num_layers}
    phi, launches = mel_eg(label, f, x, bg, ec, draws, expect)
    check(tuple(phi.shape) == (x.numel(), t_out), f"{label}: phi {tuple(phi.shape)}")
    reset_launches()
    phi_p = expected_phi(mel_explained_fn(nemo_ctc_logits, params, plain, ec, feats.shape[1]),
                         x, bg, config=ec, draws=draws)
    check(not any(LAUNCHES.values()), f"{label}: the plain twin launched a kernel")
    gate_phi(label, phi, phi_p, f"phi [{x.numel()}, {t_out}]")
    del phi_p
    mel_draw_wall(label, f, x, bg, ec)

    sd = nemo_state_dict(params)
    conv = convert_nemo_state_dict(sd, cfg, device="cuda")
    with torch.no_grad():
        lc = nemo_ctc_logits(conv, cfg, feats)
    log(f"mel nemo converter: {len(sd)} NeMo keys -> params; max|logits - original| = "
        f"{float((lc - lk).abs().max()):.3e}")
    check(torch.equal(lc, lk), "nemo converter: logits differ from the original params'")
    return launches


def nemo_bf16(cfg, params, feats, x, bg, ec, draws) -> dict:
    """NeMo large in bf16 under "default": EG through the bf16 K2f/K3b/K4f
    with exact launches, wall, profile; one draw three ways for the bf16
    rule (``phi_rule``)."""
    label = "nemo bf16"
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = cast_params_for_compute(params, "bfloat16")
    frames = feats.shape[1]
    fwd, bwd = mel_eg_passes(ec, cfg.subsampled_length(frames))
    expect = {"flash_fwd_bias_bf16": fwd * cfg.num_layers,
              "flash_dq_dbias_bf16": bwd * cfg.num_layers,
              "flash_dkv_bias_bf16": bwd * cfg.num_layers}
    with matmul_precision_scope("default"):
        with torch.no_grad():
            lk = nemo_ctc_logits(params16, cfg16, feats)
        log(f"mel {label}: transcripts {[s[:60] for s in nemo_ctc_decode(lk, NEMO_VOCAB)]}")
        f16 = mel_explained_fn(nemo_ctc_logits, params16, cfg16, ec, frames)
        _, launches = mel_eg(label, f16, x, bg, ec, draws, expect)
        mel_draw_wall(label, f16, x, bg, ec)
    one = dataclasses.replace(ec, nsamples=1)
    draw = (torch.tensor([2]), torch.tensor([0.37]))
    x_t = bg[2] + 0.37 * (x - bg[2])
    paths = {"k16": (cfg16, params16, "default"),
             "p16": (dataclasses.replace(cfg16, attention_impl="xla"), params16, "default"),
             "32": (cfg, params, "highest")}
    phi, logits = {}, {}
    for key, (c, p, precision) in paths.items():
        with matmul_precision_scope(precision):
            phi[key] = expected_phi(mel_explained_fn(nemo_ctc_logits, p, c, one, frames), x, bg,
                                    config=one, draws=draw)
            with torch.no_grad():
                logits[key] = nemo_ctc_logits(p, c, x_t.reshape(frames, -1))
        check(bool(torch.isfinite(phi[key]).all()), f"{label} {key}: phi not finite")
    defined = defined_frames(f"phi {label}", logits)
    phi_rule(f"phi {label}", phi, (("all frames", slice(None)), ("defined frames", defined)))
    return launches


def mel_conformer_float32(test_feats, x, bg, ec, draws) -> dict:
    """``ConformerConfig()`` (no positions, T_out = 301) through K2/K3/K4:
    EG with exact launches against the plain twin, a 2-clip batch with
    lengths (301, 201) through the mask variant, and DeepSHAP on the
    group-norm study variant; each against its plain twin."""
    label = "conformer"
    cfg = ConformerConfig(attention_impl="pallas")
    plain = dataclasses.replace(cfg, attention_impl="xla")
    params = init_conformer_params(SEED, cfg, device="cuda")
    randomize_affines(params, SEED + 23)
    frames, layers = test_feats.shape[1], cfg.num_layers
    f = mel_explained_fn(conformer_logits, params, cfg, ec, frames)
    fwd, bwd = mel_eg_passes(ec, frames)
    expect = {"flash_fwd": fwd * layers, "flash_dq": bwd * layers,
              "flash_dkv": bwd * layers}
    phi, launches = mel_eg(label, f, x, bg, ec, draws, expect)
    check(tuple(phi.shape) == (x.numel(), frames), f"{label}: phi {tuple(phi.shape)}")
    phi_p = expected_phi(mel_explained_fn(conformer_logits, params, plain, ec, frames), x, bg,
                         config=ec, draws=draws)
    gate_phi(label, phi, phi_p, f"phi [{x.numel()}, {frames}]")
    del phi, phi_p
    mel_draw_wall(label, f, x, bg, ec)

    lengths = torch.tensor([frames, 201], device="cuda")
    with torch.no_grad():
        reset_launches()
        lk = conformer_logits(params, cfg, test_feats, lengths=lengths)
        check(dict((k, c) for k, c in LAUNCHES.items() if c) == {"flash_fwd": layers},
              f"{label}: masked forward launches")
        lp = conformer_logits(params, plain, test_feats, lengths=lengths)
    compare(f"mel {label}: masked 2-clip logits, lengths (301, 201)", lk, lp,
            2e-3 * float(lp.abs().max()), 0.0, "2e-3 of max|logits|")

    gcfg = dataclasses.replace(cfg, conv_norm="group")
    rules = deepshap_rules()

    def dual_fn(c):
        return lambda d: aggregation_head(
            conformer_logits(params, c, d.reshape(2, frames, c.input_dim), rules=rules,
                             remat=ec.remat), ec.aggregation)[0]

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    deep = deep_shap_values(dual_fn(gcfg), x, bg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c for k, c in LAUNCHES.items() if c}
    nb = bg.shape[0]
    # per row the dual forward, remat's recompute in its backward, f at (r, r);
    # then f at (x, x)
    want = {"flash_fwd": ((2 + ec.remat) * nb + 1) * layers, "flash_dq": nb * layers,
            "flash_dkv": nb * layers}
    log(f"mel {label} deep (group norm): {nb} background rows, wall {wall:.3f} s "
        f"({wall / nb * 1e3:.1f} ms per row); launches {json.dumps(got)}")
    check(got == want, f"{label} deep: launches {got}, expected {want}")
    deep_p = deep_shap_values(dual_fn(dataclasses.replace(gcfg, attention_impl="xla")), x, bg)
    gate_phi(f"{label} deep", deep.values, deep_p.values, f"DeepSHAP phi [{x.numel()}, {frames}]")
    return launches


def time_subsampler_dgrad() -> None:
    """conv2 of the NeMo subsampler (512 -> 512, 3x3, stride 2) at the EG
    backward's 76 cotangent rows: its input gradient [76, 512, 151, 40] in
    cuDNN's bf16 (the route ``conformer.conv_subsampling`` takes in bf16),
    timed beside the alternative on float32 copies of the bf16 operands
    and beside the float32 dgrad under "highest"."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    rows, c, t_in, f_in, t_out, f_out = 76, 512, 151, 40, 76, 20
    w = torch.randn((c, c, 3, 3), generator=gen, device="cuda") * (2.0 / (9 * c)) ** 0.5
    gy = torch.randn((rows, c, t_out, f_out), generator=gen, device="cuda")
    x = torch.empty((rows, c, t_in, f_in), device="cuda")

    def dgrad(g, xx, ww):
        return torch.ops.aten.convolution_backward(g, xx, ww, None, [2, 2], [1, 1], [1, 1],
                                                   False, [0, 0], 1, [True, False, False])[0]

    fl = 2.0 * rows * t_out * f_out * c * c * 9
    with matmul_precision_scope("default"):
        bf = time_ms(lambda: dgrad(gy.to(BF16), x.to(BF16), w.to(BF16)), 5)
        f32c = time_ms(lambda: dgrad(gy.to(BF16).float(), x, w.to(BF16).float()).to(BF16), 5)
    f32 = time_ms(lambda: dgrad(gy, x, w), 5)
    log(f"timing mel subsampler conv2 dgrad [76, 512, 151, 40] (7.2 GFLOP per row): cuDNN bf16 "
        f"{bf:.3f} ms, float32 copies under \"default\" {f32c:.3f} ms, float32 under "
        f"\"highest\" {f32:.3f} ms; bound bf16 {bound_bf16(fl, 0)[0]:.3f} ms, float32 "
        f"{bound(fl, 0)[0]:.3f} ms")


def time_mel_kernels() -> None:
    """The flash kernels at the mel paths' shapes, float32 and bf16 ("timing
    mel conformer" lines): K2f at BH 8, T 76 (NeMo's forward) and K3b/K4f
    at N 608 (its EG backward, 76 rows x 8 heads); K2 at BH 4, T 301 and
    K3/K4 at N 1,204 (``ConformerConfig()``'s), each against its plain
    version, with device time, bound, plain time and SDPA's. The forwards'
    device times are over windows of 400 calls: a window of 50 calls of a
    5-12 us kernel lasts about a millisecond, and the profiler lost most of
    such a window's device records late in a full run."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    for dtype in (torch.float32, BF16):
        for h, t, full in ((8, 76, True), (4, 301, False)):
            shapes_forward(gen, h, 64, t, full, (1,), dtype, "mel conformer", 400)
            shapes_backward(gen, h, 64, t, full, dtype, 1, "mel conformer", with_device_ms=True)


def phase_mel_conformer(test_set, smi: str) -> dict:
    """The mel Conformer family at full width (NeMo stt_en_conformer_ctc_large
    widths in float32 and bf16, the converter, ``ConformerConfig()``), then
    the kernels at its shapes. Returns {kernel: launches on these paths}."""
    t0 = time.perf_counter()
    log(smi)
    ec = ExplainerConfig(method="grad", aggregation="max", nsamples=NSAMPLES, num_background=5,
                         draw_chunk=1, output_chunk=0)
    feats, x, bg = mel_inputs(test_set, ec.num_background)
    check(tuple(feats.shape) == (2, 301, 80), f"mel features {tuple(feats.shape)}")
    draws = sample_draws(torch.Generator().manual_seed(SEED + 20), num_draws(ec),
                         ec.num_background)
    cfg = dataclasses.replace(nemo_conformer_config(), attention_impl="pallas")
    params = init_nemo_ctc_params(SEED, cfg, device="cuda")
    randomize_affines(params, SEED + 19)
    launches = nemo_float32(cfg, params, feats, x, bg, ec, draws)
    launches.update(nemo_bf16(cfg, params, feats, x, bg, ec, draws))
    del params
    launches.update(mel_conformer_float32(feats, x, bg, ec, draws))
    time_subsampler_dgrad()
    time_mel_kernels()
    log(f"mel conformer phase: {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ training

TRAIN_SAMPLES = 32_000   # 2 s clips: T = 99 frames
TRAIN_BATCH = 8
TRAIN_CFG = TrainConfig(learning_rate=3e-4, num_epochs=1, batch_size=TRAIN_BATCH,
                        early_stopping_patience=5, freeze_feature_encoder=False, seed=SEED,
                        snrs_db=())
TRAIN_STEPS = 5          # timed steps per path, after 2 warm-ups
# One step's gradients through the float32 kernels against plain PyTorch:
# each leaf's max|dg| within GRAD_TOL of max(its own max|g|, GRAD_FLOOR x
# the model's largest |g|). The floor is for the leaves whose gradient is
# zero by construction and holds rounding alone: the attention's key bias
# (softmax ignores a shift of a query's scores).
GRAD_TOL = 1e-3
GRAD_FLOOR = 1e-4
# bf16: the kernels' gradients no further from float32's than plain bf16
# PyTorch's, by this factor (over the whole model, as a norm), and the loss
# within BF16_LOSS_RTOL of plain bf16's
BF16_GRAD_RATIO = 1.5
BF16_LOSS_RTOL = 1e-2
# the rel-pos conformer's position leaves: K3b's d(bias) feeds them
POS_LEAVES = ("/attn/pos/kernel", "/attn/bias_u", "/attn/bias_v")


def train_batch(seed: int = SEED) -> dict:
    """The first batch of the synthetic corpus at the training shape (8 clips
    of 2 s), on the card."""
    clip = TRAIN_SAMPLES
    b = next(synthetic_batches(seed, 1, TRAIN_BATCH, clip, max(8, clip // CHAR_DURATION + 2)))
    return {k: torch.from_numpy(v).cuda() for k, v in b.items() if not k.startswith("_")}


def train_launches(mc: Wav2Vec2Config, steps: int, forwards: int = 0, k1_on: bool = True):
    """The launches ``steps`` train steps and ``forwards`` forwards of 8 clips
    of 2 s make on a model's path: K1 once per eligible conv layer per step
    (none with a frozen feature encoder), the flash forward twice per layer
    per step (the step's forward, and its remat recompute in the backward)
    and once per layer per forward, dq and dk/dv once per layer per step."""
    k1_, f, dq, dkv = path_kernels(mc)
    layers = mc.num_hidden_layers
    convs = len(k1_main_shapes(mc, 1, TRAIN_SAMPLES)) if k1_on else 0
    want = {k1_: steps * convs, f: (2 * steps + forwards) * layers, dq: steps * layers,
            dkv: steps * layers}
    return {name: n for name, n in want.items() if n}


def check_launches(label: str, want: dict) -> dict:
    got = {name: c for name, c in LAUNCHES.items() if c}
    log(f"train {label}: launches {json.dumps(got)}")
    check(got == want, f"train {label}: launches {got}, expected exactly {want}")
    return got


def loss_and_grads(mc: Wav2Vec2Config, tcfg: TrainConfig, params, batch):
    with matmul_precision_scope(mc.matmul_precision):
        loss, grads = train_mod.make_loss_and_grads(mc, tcfg)(params, batch)
        return float(loss), grads


def plain(mc: Wav2Vec2Config) -> Wav2Vec2Config:
    return dataclasses.replace(mc, attention_impl="xla", conv_impl="lax")


def grad_gate(label: str, got: dict, want: dict, highlight=()) -> None:
    """Each leaf's gradient through the kernels against plain PyTorch's
    (``GRAD_TOL``, ``GRAD_FLOOR``); logs the worst leaves, and the leaves
    whose path ends in one of ``highlight`` on lines of their own."""
    check(got.keys() == want.keys(), f"train {label}: gradient leaves differ")
    top = max(float(g.abs().max()) for g in want.values())
    rows = []
    for name, w in want.items():
        g = got[name]
        check(bool(torch.isfinite(g).all()), f"train {label}: {name} gradient not finite")
        err, scale = float((g - w).abs().max()), float(w.abs().max())
        rows.append((err / max(scale, GRAD_FLOOR * top), err, scale, name))
    rows.sort(reverse=True)
    log(f"check train {label} gradients: {len(rows)} leaves, worst max|dg|/max(max|g|, "
        f"{GRAD_FLOOR:g} x {top:.3e}) = {rows[0][0]:.3e} at {rows[0][3]} (tolerance "
        f"{GRAD_TOL:g}: the float32 kernels are 3xTF32, float32 sums in another order)")
    for r in rows[:3]:
        log(f"check train {label} gradient {r[3]}: rel={r[0]:.3e} max|dg|={r[1]:.3e} "
            f"max|g|={r[2]:.3e}")
    for suffix in highlight:
        picked = [r for r in rows if r[3].endswith(suffix)]
        if picked:
            r = picked[0]
            log(f"check train {label} rel-pos gradients *{suffix} ({len(picked)} leaves, the "
                f"worst): rel={r[0]:.3e} max|dg|={r[1]:.3e} max|g|={r[2]:.3e} at {r[3]}")
    check(rows[0][0] <= GRAD_TOL, f"train {label}: gradient {rows[0][3]} exceeds tolerance")


def global_rel_err(got: dict, want: dict) -> float:
    num = sum(float((got[k].float() - w).square().sum()) for k, w in want.items())
    return (num / sum(float(w.square().sum()) for w in want.values())) ** 0.5


def train_base(mc: Wav2Vec2Config, params, batch) -> tuple:
    """train_synthetic at full width (one epoch of 4 batches, one validation
    batch), the exact launches of K1-K4 and nothing else; one step's loss
    and gradients against plain PyTorch; the same with a frozen feature
    encoder (no K1, the encoder bit-equal after a step). Returns (launches,
    the float32 gradients at the initial params)."""
    reset_launches()
    t0 = time.perf_counter()
    _, summary = train_synthetic(mc, TRAIN_CFG, params=params, clip_seconds=2.0,
                                 batches_per_epoch=4, val_batches_count=1, seed=SEED)
    torch.cuda.synchronize()
    log(f"train base train_synthetic: {time.perf_counter() - t0:.2f} s; summary "
        f"{json.dumps({k: v for k, v in summary.items() if k != 'example_pairs'})}")
    # a mean over the epoch's steps is finite only if each step's loss is
    for key in ("final_train_loss", "final_val_loss"):
        check(np.isfinite(summary[key]), f"train base: {key} {summary[key]} not finite")
    launches = check_launches("base train_synthetic", train_launches(mc, 4, forwards=2))

    loss, grads = loss_and_grads(mc, TRAIN_CFG, params, batch)
    loss_p, grads_p = loss_and_grads(plain(mc), TRAIN_CFG, params, batch)
    log(f"check train base loss: kernels {loss:.6f} plain {loss_p:.6f} "
        f"(rtol 1e-5: float32 CTC over the same logits' error)")
    check(abs(loss - loss_p) <= 1e-5 * abs(loss_p), "train base: loss exceeds tolerance")
    grad_gate("base", grads, grads_p)

    frozen = dataclasses.replace(TRAIN_CFG, freeze_feature_encoder=True)
    loss_f, grads_f = loss_and_grads(mc, frozen, params, batch)
    _, grads_fp = loss_and_grads(plain(mc), frozen, params, batch)
    check(not any(k.startswith("feature_encoder/") for k in grads_f),
          "train frozen: the feature encoder has gradients")
    check(abs(loss_f - loss) <= 1e-6 * abs(loss), "train frozen: loss differs from unfrozen")
    grad_gate("frozen", grads_f, grads_fp)
    p = train_mod.clone_params(params)
    opt = train_mod.make_optimizer(frozen)
    state = opt.init(train_mod.trainable_leaves(p, frozen))
    reset_launches()
    with matmul_precision_scope(mc.matmul_precision):
        train_mod.make_train_step(mc, frozen, opt)(p, state, batch)
    torch.cuda.synchronize()
    got = check_launches("frozen step", train_launches(mc, 1, k1_on=False))
    before, after = dict(train_mod.named_leaves(params)), dict(train_mod.named_leaves(p))
    fe = [k for k in before if k.startswith("feature_encoder/")]
    check(all(torch.equal(before[k], after[k]) for k in fe),
          "train frozen: the feature encoder moved")
    check(not torch.equal(before["lm_head/kernel"], after["lm_head/kernel"]),
          "train frozen: the head did not move")
    log(f"check train frozen: {len(fe)} feature-encoder leaves bit-equal after the step")
    for name, c in got.items():
        launches[name] = launches.get(name, 0) + c
    return launches, grads


def train_bf16(mc16: Wav2Vec2Config, params, batch, grads32: dict) -> dict:
    """Two bf16 steps with the exact launches of the bf16 kernels and no
    float32 kernel, float32 masters after them; one step's loss and
    gradients through the kernels and plain bf16 PyTorch, each against the
    float32 kernels' gradients at the same params."""
    p = train_mod.clone_params(params)
    opt = train_mod.make_optimizer(TRAIN_CFG)
    state = opt.init(train_mod.trainable_leaves(p, TRAIN_CFG))
    step = train_mod.make_train_step(mc16, TRAIN_CFG, opt)
    reset_launches()
    losses = []
    with matmul_precision_scope(mc16.matmul_precision):
        for _ in range(2):
            _, _, loss = step(p, state, batch)
            losses.append(float(loss))
    launches = check_launches("bf16 steps", train_launches(mc16, 2))
    check(all(np.isfinite(losses)), f"train bf16: losses {losses}")
    leaves = dict(train_mod.named_leaves(p))
    check(all(t.dtype == torch.float32 for t in leaves.values())
          and all(t.dtype == torch.float32 for t in state["mu"].values()),
          "train bf16: the master params or the optimizer state left float32")
    log(f"train bf16: losses {losses}; {len(leaves)} master leaves and the AdamW state "
        f"float32")
    loss_k, g_k = loss_and_grads(mc16, TRAIN_CFG, params, batch)
    loss_p, g_p = loss_and_grads(plain(mc16), TRAIN_CFG, params, batch)
    e_k, e_p = global_rel_err(g_k, grads32), global_rel_err(g_p, grads32)
    worst = max((float((g_k[k].float() - g_p[k]).abs().max()) / float(g_p[k].abs().max()), k)
                for k in g_p if float(g_p[k].abs().max()) > 0)
    log(f"check train bf16: loss kernels {loss_k:.5f} plain bf16 {loss_p:.5f} (rtol "
        f"{BF16_LOSS_RTOL:g}); gradients vs float32 kernels: |dg|/|g| kernels {e_k:.3e}, "
        f"plain bf16 {e_p:.3e} (gate: at most {BF16_GRAD_RATIO}x plain's); kernels vs plain "
        f"bf16, information: worst leaf max|dg|/max|g| {worst[0]:.3e} at {worst[1]}")
    check(abs(loss_k - loss_p) <= BF16_LOSS_RTOL * abs(loss_p), "train bf16: loss exceeds "
          "tolerance")
    check(e_k <= BF16_GRAD_RATIO * e_p, "train bf16: gradients further from float32's "
          "than plain bf16's")
    return launches


def train_conformer(cmc: Wav2Vec2ConformerConfig, cparams, batch) -> dict:
    """Two rel-pos conformer steps with the exact launches of K1, K2f, K3b
    and K4f; one step's gradients against plain PyTorch, the position
    leaves (fed by K3b's d(bias)) on lines of their own."""
    p = train_mod.clone_params(cparams)
    opt = train_mod.make_optimizer(TRAIN_CFG)
    state = opt.init(train_mod.trainable_leaves(p, TRAIN_CFG))
    step = train_mod.make_train_step(cmc, TRAIN_CFG, opt)
    reset_launches()
    losses = []
    with matmul_precision_scope(cmc.matmul_precision):
        for _ in range(2):
            _, _, loss = step(p, state, batch)
            losses.append(float(loss))
    launches = check_launches("conformer steps", train_launches(cmc, 2))
    check(all(np.isfinite(losses)), f"train conformer: losses {losses}")
    del p, state
    loss, grads = loss_and_grads(cmc, TRAIN_CFG, cparams, batch)
    loss_p, grads_p = loss_and_grads(plain(cmc), TRAIN_CFG, cparams, batch)
    log(f"check train conformer loss: kernels {loss:.6f} plain {loss_p:.6f} (rtol 1e-5); "
        f"steps' losses {losses}")
    check(abs(loss - loss_p) <= 1e-5 * abs(loss_p), "train conformer: loss exceeds tolerance")
    grad_gate("conformer", grads, grads_p, POS_LEAVES)
    return launches


def ctc_on_card(batch, mc: Wav2Vec2Config) -> None:
    """ctc_loss at the step's shape [8, 99, 32] against F.ctc_loss(reduction=
    "none").mean() on the card (a check only: F.ctc_loss is not the port's
    loss), held to F.ctc_loss on the logits in float64 (its float32 run
    carries several times ours's error there: logged); both timed, forward
    and backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    lengths = feature_lengths(mc, batch["audio_lengths"])
    t = mc.frames_for_samples(TRAIN_SAMPLES)
    logits = torch.randn((TRAIN_BATCH, t, mc.vocab_size), device="cuda", generator=gen)
    labels, label_lengths = batch["labels"], batch["label_lengths"]

    def ours(x=logits):
        x = x.detach().requires_grad_()
        loss = ctc_loss(x, lengths, labels, label_lengths)
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    def library(x=logits):
        x = x.detach().requires_grad_()
        lp = F.log_softmax(x, -1).transpose(0, 1)
        loss = F.ctc_loss(lp, labels.long(), lengths.long(), label_lengths.long(),
                          reduction="none").mean()
        return loss.detach(), torch.autograd.grad(loss, x)[0]

    (loss, g), (want, want_g) = ours(), library(logits.double())
    lib_g = library()[1]
    log(f"check ctc_loss [8, {t}, {mc.vocab_size}]: ours {float(loss):.6f} F.ctc_loss in "
        f"float64 {float(want):.6f} (rtol 1e-5); F.ctc_loss in float32's gradient: max|dg| "
        f"{float((lib_g.double() - want_g).abs().max()):.3e} from float64's (information)")
    check(abs(float(loss) - float(want)) <= 1e-5 * abs(float(want)), "ctc_loss value")
    compare("ctc_loss d/dlogits", g.double(), want_g, 1e-4 * float(want_g.abs().max()), 0.0,
            "float32 recursions over 99 frames against float64")
    t1 = time.perf_counter()
    ms, lms = time_ms(ours, 5), time_ms(library, 10)
    dev = device_ms_per_call(ours, 2, host_ops=False)
    ldev = device_ms_per_call(library, 10, host_ops=False)
    log(f"timing train ctc_loss forward+backward [8, {t}, 32]: ms={ms:.3f} device_ms={dev:.3f} "
        f"library_ms(F.ctc_loss)={lms:.3f} library_device_ms={ldev:.3f} (timed in "
        f"{time.perf_counter() - t1:.1f} s)")


def time_train_path(label: str, mc: Wav2Vec2Config, params, batch, smi: str) -> dict:
    """Wall per step (median of TRAIN_STEPS after 2 warm-ups, each ending in
    the loss's read-out and a synchronize), utterances and audio seconds
    per second, peak device memory, then two profiled steps; the CTC loss
    (forward and backward) and AdamW alone beside them."""
    p = train_mod.clone_params(params)
    opt = train_mod.make_optimizer(TRAIN_CFG)
    leaves = train_mod.trainable_leaves(p, TRAIN_CFG)
    state = opt.init(leaves)
    step = train_mod.make_train_step(mc, TRAIN_CFG, opt)
    with matmul_precision_scope(mc.matmul_precision):
        for _ in range(2):
            float(step(p, state, batch)[2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            float(step(p, state, batch)[2])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall = float(np.median(walls))
        audio_s = TRAIN_BATCH * TRAIN_SAMPLES / 16_000
        log(f"timing train {label}: wall per step {wall * 1e3:.1f} ms (median of "
            f"{TRAIN_STEPS} after 2 warm-ups; {min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f}); "
            f"{TRAIN_BATCH / wall:.1f} utterances/s, {audio_s / wall:.1f} audio s/s; peak "
            f"device memory {peak:.2f} GiB ({smi})")
        t1 = time.perf_counter()
        prof = profile_calls(lambda: [float(step(p, state, batch)[2]) for _ in range(2)], 2,
                             unit="step", tag=f"profile train {label}", host_ops=False)
        log(f"profile train {label}: profiled in {time.perf_counter() - t1:.1f} s")
        busy = sum(prof.values())
        grads = {k: torch.randn_like(t) * 1e-3 for k, t in leaves.items()}
        adam = lambda: opt.apply(leaves, grads, state)  # noqa: E731
        a_ms, a_dev = time_ms(adam, 5), device_ms_per_call(adam, 5, host_ops=False)
    log(f"timing train {label} AdamW (clip + update, {len(leaves)} leaves, "
        f"{sum(t.numel() for t in leaves.values()) / 1e6:.1f} M params): ms={a_ms:.3f} "
        f"device_ms={a_dev:.3f} ({100 * a_ms / (wall * 1e3):.1f}% of the step's wall, "
        f"{100 * a_dev / busy if busy else float('nan'):.1f}% of its device busy)")
    return dict(wall_ms=wall * 1e3, busy_ms=busy, peak_gib=peak)


def train_cli(base_archive: str, data_dir: str, mc: Wav2Vec2Config) -> None:
    """``train --params <the base archive> --epochs 1 --batches-per-epoch 2
    --clip-seconds 2``: its exact launches (2 steps, 8 validation and 8
    held-out forwards), the written archive equal to what train_synthetic
    returned, the summary's keys (the reference's, and params_path)."""
    out = f"{data_dir}/trained_base.npz"
    returned = []
    inner = train_syn_mod.train_synthetic

    def capture(*args, **kw):
        returned.append(inner(*args, **kw))
        return returned[-1]

    train_syn_mod.train_synthetic = capture
    try:
        (summary,), launches, wall = run_cli("train", [
            "train", "--params", base_archive, "--epochs", "1", "--batches-per-epoch", "2",
            "--clip-seconds", "2", "--out", out])
    finally:
        train_syn_mod.train_synthetic = inner
    want = train_launches(mc, 2, forwards=16)
    check(launches == want, f"cli train: launches {launches}, expected exactly {want}")
    check(set(summary) == {"epochs_run", "final_train_loss", "final_val_loss",
                           "heldout_greedy_wer", "target_wer", "reached_target",
                           "train_wall_s", "n_eval_utterances", "example_pairs", "params_path"},
          f"cli train: summary keys {sorted(summary)}")
    check(np.isfinite(summary["final_train_loss"]), "cli train: loss not finite")
    check(load_config(out) == mc, "cli train: the archive's config is not the base's")
    loaded = dict(train_mod.named_leaves(load_params(out, device="cuda")))
    trained = dict(train_mod.named_leaves(returned[0][0]))
    check(loaded.keys() == trained.keys()
          and all(torch.equal(loaded[k], trained[k]) for k in trained),
          "cli train: the archive differs from what train_synthetic returned")
    log(f"cli train: {wall:.2f} s; the archive's {len(loaded)} leaves equal the trained "
        f"params")


def train_kernel_shapes(base: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig) -> None:
    """Every kernel of the training paths at the step's shapes, against its
    plain version and timed beside its bound and a library call ("timing
    train" lines): K1 at 8 rows (one per clip), K2/K3/K4 at B.H = 96 with
    one cotangent row per residual row, in float32 and bf16; K2f/K3b/K4f at
    B.H = 128 in float32."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    t = base.frames_for_samples(TRAIN_SAMPLES)
    for dtype in (torch.float32, BF16):
        explainer_shapes_k1(gen, base, dtype, TRAIN_SAMPLES, what="a training batch",
                            tag="train", rows=TRAIN_BATCH)
        shapes_forward(gen, base.num_attention_heads, base.head_dim, t, False, (TRAIN_BATCH,),
                       dtype, "train", device_iters=200)
        shapes_backward(gen, base.num_attention_heads, base.head_dim, t, False, dtype,
                        TRAIN_BATCH, "train", with_device_ms=True, rows=1)
    shapes_forward(gen, conformer.num_attention_heads, conformer.head_dim, t, True,
                   (TRAIN_BATCH,), torch.float32, "train", device_iters=200)
    shapes_backward(gen, conformer.num_attention_heads, conformer.head_dim, t, True,
                    torch.float32, TRAIN_BATCH, "train", with_device_ms=True, rows=1)


def phase_train(model: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig, base_archive: str,
                data_dir: str, smi: str) -> dict:
    """CTC training at full width: Wav2Vec2-base in float32 (train_synthetic,
    gradients against plain PyTorch, frozen feature encoder), in bf16, the
    rel-pos conformer in float32; ctc_loss against F.ctc_loss; the train
    command; the per-step timing and the kernels at the step's shapes.
    Returns {kernel: launches} of the counted runs (the JSON line's
    ``launches_train``)."""
    t0 = time.perf_counter()
    log(smi)

    def part(what: str) -> None:
        log(f"train phase: {what} done at {time.perf_counter() - t0:.1f} s")

    batch = train_batch()
    params = init_wav2vec2_params(SEED, model, device="cuda")
    launches, grads32 = train_base(model, params, batch)
    part("base float32")
    model16 = dataclasses.replace(model, dtype="bfloat16", matmul_precision="default")
    for name, c in train_bf16(model16, params, batch, grads32).items():
        launches[name] = launches.get(name, 0) + c
    del grads32
    part("base bf16")
    ctc_on_card(batch, model)
    part("ctc_loss")
    timings = {"base": time_train_path("base float32", model, params, batch, smi),
               "bf16": time_train_path("base bf16", model16, params, batch, smi)}
    del params
    part("base timing")
    train_cli(base_archive, data_dir, model)
    part("cli")
    cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
    part("conformer init")
    for name, c in train_conformer(conformer, cparams, batch).items():
        launches[name] = launches.get(name, 0) + c
    part("conformer")
    timings["conformer"] = time_train_path("conformer float32", conformer, cparams, batch, smi)
    del cparams
    part("conformer timing")
    train_kernel_shapes(model, conformer)
    for label, tm in timings.items():
        log(f"timing train summary {label}: {tm['wall_ms']:.1f} ms per step, device busy "
            f"{tm['busy_ms']:.1f} ms per step ({100 * tm['busy_ms'] / tm['wall_ms']:.1f}% of "
            f"the unprofiled wall), peak {tm['peak_gib']:.2f} GiB ({smi})")
    log(f"train phase: {time.perf_counter() - t0:.1f} s; launches {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------- scale-out

# The per-draw device ms of the six feature-encoder backwards, from PERF.md's
# kernel table (one H100 80GB HBM3, 700 W): K1 and cuDNN's dgrad
K1_TABLE_MS = {"float32": 42.94, "bfloat16": 3.69}
CUDNN_TABLE_MS = {"float32": 65.96, "bfloat16": 7.74}
SCALE_DRAW = (2, 0.37)  # (background row, t) of the one-draw comparisons


def scale_inputs(test_set):
    """The one-draw comparisons' clip (the noisy sample, normalized), its
    seeded background and the draw, on the card."""
    x = zero_mean_unit_var(torch.from_numpy(test_set[1]["audio"]).cuda())
    bg = 0.01 * torch.randn((5, N_SAMPLES), generator=torch.Generator().manual_seed(1)).cuda()
    draws = (torch.tensor([SCALE_DRAW[0]]), torch.tensor([SCALE_DRAW[1]]))
    return x, bg, draws


def one_draw_config(explainer: ExplainerConfig) -> ExplainerConfig:
    return dataclasses.replace(explainer, nsamples=1, draw_chunk=1)


def scale_native(data_dir: str, smi: str) -> None:
    """The host runtime: the batch WER counts of 3,000 seeded pairs against
    the plain DP; the base path's phi written by the writer and by the pool
    (the same bytes) against np.save (the same length and data; the C
    writer spells a 2-D shape "(r, c, )" in the header); a 1-D clip's bytes
    equal to np.save's; the wall of a synchronous write beside a submit."""
    rng = np.random.default_rng(SEED)
    refs = [[int(v) for v in rng.integers(0, 40, rng.integers(1, 30))] for _ in range(3000)]
    hyps = [[int(v) for v in rng.integers(0, 40, rng.integers(0, 30))] for _ in range(3000)]
    t0 = time.perf_counter()
    got = native.batch_wer_native(refs, hyps)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.asarray([word_edit_counts(r, h) for r, h in zip(refs, hyps)], np.int32)
    t_plain = time.perf_counter() - t0
    check(np.array_equal(got, want), "native: batch WER counts differ from the plain DP")
    log(f"scale native: batch_wer_native on 3000 pairs equals the plain DP; {t_native * 1e3:.2f} "
        f"ms native against {t_plain * 1e3:.1f} ms plain Python (host)")
    sample = AttributionStore(f"{data_dir}/base").load(key_for(1, "noisy", 5.0))
    phi = sample["shap_values"]
    check(phi.dtype == np.float32 and phi.ndim == 2, f"native: phi {phi.dtype} {phi.shape}")
    d = Path(data_dir) / "scale_native"
    d.mkdir()
    t0 = time.perf_counter()
    np.save(d / "plain.npy", phi)
    t_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.write_npy_f32_native(str(d / "writer.npy"), phi)
    t_sync = time.perf_counter() - t0
    with native.NpyWriterPool(2) as pool:
        t0 = time.perf_counter()
        pool.submit(str(d / "pool.npy"), phi)
        t_submit = time.perf_counter() - t0
        failed = pool.flush()
        t_flush = time.perf_counter() - t0
    check(failed == 0, f"native: {failed} pool write(s) failed")
    plain, writer, pooled = ((d / n).read_bytes() for n in ("plain.npy", "writer.npy",
                                                           "pool.npy"))
    check(writer == pooled, "native: the pool's bytes differ from the writer's")
    check(len(writer) == len(plain) and writer[128:] == plain[128:],
          "native: the data section differs from np.save's")
    check(writer[:128].replace(b", ), }", b"), }  ") == plain[:128],
          "native: the header differs from np.save's beyond the shape's spelling")
    audio = np.asarray(sample["audio"], np.float32)
    native.write_npy_f32_native(str(d / "audio.npy"), audio)
    np.save(d / "audio_plain.npy", audio)
    check((d / "audio.npy").read_bytes() == (d / "audio_plain.npy").read_bytes(),
          "native: a 1-D array's bytes differ from np.save's")
    log(f"scale native: phi {phi.shape} ({len(writer) / 1e6:.1f} MB): writer and pool "
        f"byte-equal, np.save's length and data (header: shape spelled "
        f"{writer[60:80]!r}); 1-D audio byte-equal to np.save")
    log(f"scale native walls (host, {smi}): np.save {t_np * 1e3:.1f} ms, synchronous native "
        f"write {t_sync * 1e3:.1f} ms, pool submit {t_submit * 1e3:.2f} ms (flushed after "
        f"{t_flush * 1e3:.1f} ms)")


def conv_backward_ms(params, mc: Wav2Vec2Config, impl: str, rows: int) -> float:
    """ms (CUDA events) of the explainer's backward through the six eligible
    feature-encoder layers with ``impl``: per layer the vmapped VJP of
    ``rows`` cotangent rows, as one draw runs it, summed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dtype = torch.bfloat16 if mc.dtype == "bfloat16" else torch.float32
    total = 0.0
    layers = [i for i, (c_in, c, s) in enumerate(zip((1,) + mc.conv_dim[:-1], mc.conv_dim,
                                                     mc.conv_stride))
              if k1.eligible(c_in, c, s, 1, 0)]
    for i, (k, s, c_in, c_out, t_in, t_out) in zip(layers, k1_main_shapes(mc, 1)):
        w = params["feature_encoder"][i]["conv"]["kernel"].to(dtype)
        x = torch.randn((1, t_in, c_in), generator=gen, device="cuda").to(dtype)
        ybar = torch.randn((rows, 1, t_out, c_out), generator=gen, device="cuda").to(dtype)
        _, vjp = torch.func.vjp(lambda v: _conv1d(v, w, stride=s, impl=impl), x)
        total += time_ms(lambda: torch.func.vmap(lambda c: vjp(c)[0])(ybar), 5)
    return total


def scale_conv_formulations(model: Wav2Vec2Config, explainer: ExplainerConfig, params,
                            test_set, smi: str) -> dict:
    """conv_impl "gemm" and "hybrid" against "pallas" at full width: one
    draw's phi in float32 "highest" (within 1e-4 of max|phi|) and in bf16
    "default" (the bf16 rule of phase 7, against the plain bf16 path and
    float32); the six feature-encoder backwards per draw of each
    formulation and of the library's conv ("lax"). Returns the timings."""
    ec = one_draw_config(explainer)
    x, bg, draws = scale_inputs(test_set)
    x_t = bg[2] + 0.37 * (x - bg[2])
    t_out = model.frames_for_samples(N_SAMPLES)
    out = {}
    phi32 = {}
    for impl in ("pallas", "gemm", "hybrid"):
        mc = dataclasses.replace(model, conv_impl=impl)
        phi32[impl] = expected_phi(make_explained_fn(params, mc, ec), x, bg, config=ec,
                                   draws=draws)
    scale = float(phi32["pallas"].abs().max())
    for impl in ("gemm", "hybrid"):
        err = compare(f"scale conv {impl} float32, phi against pallas (one draw)", phi32[impl],
                      phi32["pallas"], 1e-4 * scale, 0.0, "1e-4 of max|phi|: the same sums "
                      "in another order in the feature encoder's backward")
        log(f"scale conv {impl} float32: max_abs_err / max|phi| = {err / scale:.3e}")
    params16 = cast_params_for_compute(params, "bfloat16")
    m16 = dataclasses.replace(model, dtype="bfloat16", matmul_precision="default")
    p16 = dataclasses.replace(m16, attention_impl="xla", conv_impl="lax")
    with matmul_precision_scope("default"):
        with torch.no_grad():
            logits = {"p16": wav2vec2_logits(params16, p16, x_t[None])[0]}
        phi_p16 = expected_phi(make_explained_fn(params16, p16, ec), x, bg, config=ec,
                               draws=draws)
    with torch.no_grad():
        logits["32"] = wav2vec2_logits(params, model, x_t[None])[0]
    for impl in ("gemm", "hybrid"):
        mc = dataclasses.replace(m16, conv_impl=impl)
        with matmul_precision_scope("default"):
            phi_k16 = expected_phi(make_explained_fn(params16, mc, ec), x, bg, config=ec,
                                   draws=draws)
            with torch.no_grad():
                lg = dict(logits, k16=wav2vec2_logits(params16, mc, x_t[None])[0])
        label = f"scale conv {impl} bf16"
        defined = defined_frames(label, lg)
        phi_rule(label, {"k16": phi_k16, "p16": phi_p16, "32": phi32["pallas"]},
                 (("all frames", slice(None)), ("defined frames", defined)))
    for dtype, mc, p, prec in (("float32", model, params, "highest"),
                               ("bfloat16", m16, params16, "default")):
        with matmul_precision_scope(prec):
            for impl in ("pallas", "gemm", "hybrid", "lax"):
                out[(dtype, impl)] = conv_backward_ms(p, mc, impl, t_out)
        log(f"timing scale conv backward {dtype} per draw (six feature-encoder layers, "
            f"{t_out} cotangent rows, CUDA events; {smi}): "
            + ", ".join(f"{impl} {out[(dtype, impl)]:.2f} ms" for impl in
                        ("gemm", "hybrid", "pallas", "lax"))
            + f"; PERF.md's table: K1 {K1_TABLE_MS[dtype]} ms, cuDNN's dgrad "
              f"{CUDNN_TABLE_MS[dtype]} ms")
    return out


def scale_mesh_world1(model: Wav2Vec2Config, explainer: ExplainerConfig, params, test_set,
                      data_dir: str):
    """A mesh of one NCCL rank (file init under the phase's directory):
    run_shap_pipeline with sample_batch 1 (the draw-sharded path) and 2
    (the sample-sharded path) against the unmeshed run: phi bit-equal and
    the same launches of every kernel. Returns (the unmeshed phis, the
    meshed runs' launches summed: the JSON line's launches_scale)."""
    runs = {}
    dist.init_process_group("nccl", init_method=f"file://{data_dir}/nccl_init", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        for label, sb, m, det in (("unmeshed cuDNN default", 1, None, False),
                                  ("unmeshed", 1, None, True), ("mesh sb1", 1, mesh, True),
                                  ("mesh sb2", 2, mesh, True)):
            cfg = PipelineConfig(model=model, explainer=explainer, seed=SEED, sample_batch=sb,
                                 data_dir=f"{data_dir}/scale_{label.replace(' ', '_')}")
            reset_launches()
            t0 = time.perf_counter()
            with deterministic_convs() if det else contextlib.nullcontext():
                res = run_shap_pipeline(params, cfg, test_set, device="cuda", mesh=m)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[label] = ([r["shap_values"] for r in res], dict(LAUNCHES), wall)
            log(f"scale mesh world 1 {label}: {len(res)} samples in {wall:.2f} s; launches "
                f"{json.dumps({k: v for k, v in LAUNCHES.items() if v})}")
    finally:
        dist.destroy_process_group()
    flat, flat_launches, _ = runs["unmeshed"]
    moved = max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                for a, b in zip(runs["unmeshed cuDNN default"][0], flat))
    log(f"scale mesh world 1: cuDNN's default algorithms against its deterministic ones, "
        f"largest move of phi {moved:.3e} of max|phi| (information)")
    scale_launches = {name: 0 for name in LAUNCHES}
    for label in ("mesh sb1", "mesh sb2"):
        phis, launches, _ = runs[label]
        check(all(np.array_equal(a, b) for a, b in zip(phis, flat)),
              f"scale mesh world 1 {label}: phi not bit-equal to the unmeshed run")
        check(launches == flat_launches, f"scale mesh world 1 {label}: launches {launches} "
              f"differ from the unmeshed run's {flat_launches}")
        for name, c in launches.items():
            scale_launches[name] += c
    for name in BASE_KERNELS:
        check(scale_launches[name] > 0, f"scale mesh world 1: {name} not launched")
    log("scale mesh world 1: phi bit-equal to the unmeshed run at sample_batch 1 and 2, "
        "the same launches of every kernel")
    return flat, scale_launches


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN restricted to its deterministic algorithms inside the block: by
    default its dgrad may sum with atomics, and phi then moves in its last
    bits from one run to the next (the first conv layer's and the
    positional conv's input gradients go through cuDNN)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def scale_configs():
    model = Wav2Vec2Config(attention_impl="pallas", conv_impl="pallas")
    conformer = Wav2Vec2ConformerConfig(attention_impl="pallas", conv_impl="pallas")
    explainer = ExplainerConfig(nsamples=NSAMPLES, method="grad", aggregation="max",
                                draw_chunk=1, output_chunk=0, num_background=5)
    return model, conformer, explainer


def _scale_rank_work(rank: int, data_dir: str) -> dict:
    """One of two ranks on the one card: the meshed pipeline at sample_batch
    1 (draws sharded) and 2 (samples sharded), then model_parallel=2: the
    base's logits and one draw's phi, the rel-pos-large conformer's
    logits."""
    model, conformer, explainer = scale_configs()
    params = init_wav2vec2_params(SEED, model, device="cuda")
    test_set = make_test_set()
    mesh = make_mesh(MeshConfig(), device="cuda")
    out = {"rank": rank}
    x, bg, draws = scale_inputs(test_set)
    ec = one_draw_config(explainer)
    # one untimed draw first: the walls below are the pipelines', not the
    # process's first launches
    expected_phi(make_explained_fn(params, model, ec), x, bg, config=ec, draws=draws)
    for sb in (1, 2):
        cfg = PipelineConfig(model=model, explainer=explainer, seed=SEED, sample_batch=sb,
                             data_dir=f"{data_dir}/scale_two_ranks_{sb}")
        reset_launches()
        t0 = time.perf_counter()
        with deterministic_convs():
            res = run_shap_pipeline(params, cfg, test_set, mesh=mesh)
        torch.cuda.synchronize()
        out[f"wall {sb}"] = time.perf_counter() - t0
        out[f"launches {sb}"] = {k: v for k, v in LAUNCHES.items() if v}
        out[f"phi {sb}"] = [r["shap_values"] for r in res]
    tp = make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device="cuda")
    local = shard_params_tp(params, tp)
    del params
    with torch.no_grad():
        out["logits base"] = wav2vec2_logits(local, model, x[None], tp=tp).cpu().numpy()
    reset_launches()
    out["phi tp"] = expected_phi(make_explained_fn(local, model, ec, tp=tp), x, bg, config=ec,
                                 draws=draws).cpu().numpy()
    out["launches tp"] = {k: v for k, v in LAUNCHES.items() if v}
    del local
    cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
    clocal = shard_params_tp(cparams, tp)
    del cparams
    with torch.no_grad():
        out["logits conformer"] = w2v2_conformer_logits(clocal, conformer, x[None],
                                                        tp=tp).cpu().numpy()
    return out


def _scale_rank(rank: int, init_file: str, data_dir: str, queue) -> None:
    """A spawned rank on cuda:0 of a 2-rank gloo group (NCCL refuses two
    ranks on one card); its results, or its traceback, go to ``queue``."""
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        with highest_precision():
            queue.put((rank, _scale_rank_work(rank, data_dir), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def scale_two_ranks(model: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig,
                    explainer: ExplainerConfig, params, test_set, flat, data_dir: str,
                    smi: str) -> None:
    """Two processes on the one card over gloo: draw-sharded phi within
    1e-6 of max|phi| of the single-rank run over the same draws,
    sample-sharded phi equal to it, the hand kernels launched on both
    paths; TP at model_parallel=2: the base's logits and the rel-pos-large
    conformer's (8 heads per rank) within 1e-5 of max|logits| of unsharded,
    one draw's phi (the waveform gradient) within 1e-4 of max|phi|. The
    unsharded references run here while the ranks run."""
    # this process's cached blocks back to the card, which the ranks share
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_scale_rank, args=(r, f"{data_dir}/gloo_init", data_dir,
                                                      queue)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        x, bg, draws = scale_inputs(test_set)
        ec = one_draw_config(explainer)
        with torch.no_grad():
            want = {"logits base": wav2vec2_logits(params, model, x[None]).cpu().numpy()}
        want["phi tp"] = expected_phi(make_explained_fn(params, model, ec), x, bg, config=ec,
                                      draws=draws).cpu().numpy()
        cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
        with torch.no_grad():
            want["logits conformer"] = w2v2_conformer_logits(cparams, conformer,
                                                             x[None]).cpu().numpy()
        del cparams
        for _ in procs:
            rank, out, err = queue.get(timeout=900)
            check(err is None, f"scale two ranks: rank {rank} failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    for rank in (0, 1):
        out = got[rank]
        log(f"scale two ranks rank {rank}: pipeline walls sample_batch 1 {out['wall 1']:.2f} s, "
            f"2 {out['wall 2']:.2f} s ({smi}, two processes sharing the card); launches "
            f"sample_batch 1 {json.dumps(out['launches 1'])}, 2 {json.dumps(out['launches 2'])}, "
            f"TP draw {json.dumps(out['launches tp'])}")
        for name in BASE_KERNELS:
            for key in ("launches 1", "launches 2", "launches tp"):
                check(out[key].get(name, 0) > 0, f"scale two ranks rank {rank}: {name} not "
                      f"launched ({key})")
        for j, want_phi in enumerate(flat):
            scale = float(np.abs(want_phi).max())
            err = float(np.abs(out["phi 1"][j] - want_phi).max())
            log(f"scale two ranks rank {rank} draw-sharded sample {j}: max_abs_err / max|phi| "
                f"= {err / scale:.3e} (limit 1e-6: the same draws, summed in another order)")
            check(err <= 1e-6 * scale, "scale two ranks: draw-sharded phi off the single rank's")
            check(np.array_equal(out["phi 2"][j], want_phi),
                  f"scale two ranks rank {rank}: sample-sharded phi not equal to the single "
                  "rank's")
        for key, limit in (("logits base", 1e-5), ("logits conformer", 1e-5),
                           ("phi tp", 1e-4)):
            scale = float(np.abs(want[key]).max())
            err = float(np.abs(out[key] - want[key]).max())
            log(f"scale two ranks rank {rank} TP {key}: max_abs_err / max|.| = "
                f"{err / scale:.3e} (limit {limit:g}: the row-parallel sums split over two "
                "ranks)")
            check(err <= limit * scale, f"scale two ranks: TP {key} off the unsharded")
    log(f"scale two ranks: {wall:.1f} s with the spawn; sample-sharded phi equal, "
        "draw-sharded and TP within their limits on both ranks")


def scale_cli(base_archive: str, data_dir: str) -> None:
    """run-shap --sample-batch 2 --async-writes on the base kernel archive,
    and a plain run (--sample-batch 1, synchronous writes), then sweep on
    each: the same .npy bytes (cuDNN's deterministic algorithms in both) and
    the same sweep records."""
    args = ["--num-samples", "1", "--snrs", "5", "--min-length", str(N_SAMPLES),
            "--max-length", str(N_SAMPLES), "--nsamples", "2"]
    stores = {}
    for label, extra in (("async", ["--sample-batch", "2", "--async-writes"]),
                         ("plain", ["--sample-batch", "1"])):
        d = Path(data_dir) / f"scale_cli_{label}"
        with deterministic_convs():
            (run,), launches, wall = run_cli(f"scale {label}", ["run-shap", "--params",
                                                                base_archive, "--data-dir",
                                                                str(d), *args, *extra])
        for name in BASE_KERNELS:
            check(launches.get(name, 0) > 0, f"scale cli {label}: {name} not launched")
        lines, _, _ = run_cli(f"scale {label}", ["sweep", "--params", base_archive,
                                                 "--data-dir", str(d)])
        stores[label] = ({p.name: p.read_bytes() for p in d.glob("*.npy")}, lines)
        log(f"scale cli {label}: run-shap {wall:.2f} s for {run['computed']} samples")
    (files, lines), (plain_files, plain_lines) = stores["async"], stores["plain"]
    check(len(files) == 8 and files == plain_files,
          "scale cli: the async store's files differ from the plain run's")
    check(lines == plain_lines, "scale cli: the sweep records differ")
    log("scale cli: --sample-batch 2 --async-writes wrote the plain run's bytes; equal sweeps")


def phase_scale(base_archive: str, data_dir: str, smi: str) -> dict:
    """The host runtime, the conv formulations and run-shap's scale-out on
    the card (Wav2Vec2-base at full width, the kernel impls, the two clips,
    4 draws each). Returns the JSON line's launches_scale."""
    t0 = time.perf_counter()
    log(smi)
    model, conformer, explainer = scale_configs()
    test_set = make_test_set()
    params = init_wav2vec2_params(SEED, model, device="cuda")

    def part(what: str) -> None:
        log(f"scale phase: {what} done at {time.perf_counter() - t0:.1f} s")

    scale_native(data_dir, smi)
    part("native")
    flat, launches = scale_mesh_world1(model, explainer, params, test_set, data_dir)
    part("mesh world 1")
    scale_two_ranks(model, conformer, explainer, params, test_set, flat, data_dir, smi)
    part("two ranks")
    scale_conv_formulations(model, explainer, params, test_set, smi)
    part("conv formulations")
    scale_cli(base_archive, data_dir)
    part("cli")
    log("scale phase: crash recovery is not provoked on the card (a lost device cannot be "
        "made on purpose here); tests/test_torch_scaleout.py holds it on the CPU")
    log(f"scale phase: {time.perf_counter() - t0:.1f} s; launches_scale "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


# ------------------------------------------------------ data-parallel training

DP_TIMED = 3  # timed steps per run, after one warm-up
# the two ranks' all-reduced gradients against one rank's on the whole
# batch: each leaf's max|dg| within DP_GRAD_TOL of its max|g|, floored at
# GRAD_FLOOR x the model's largest |g| (the attention's key bias has a zero
# gradient by construction and holds rounding alone)
DP_GRAD_TOL = 1e-4


@contextlib.contextmanager
def deterministic_training():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations inside the block (warn only, so an op without one
    runs and is named in the caught warnings the block yields): the CTC
    loss's gather sums its backward with atomics otherwise."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    # the mode's NaN fill of new tensors is a cost, not a determinism
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with deterministic_convs(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
        torch.utils.deterministic.fill_uninitialized_memory = fill


def tree_digest(*trees) -> str:
    """sha256 over the bytes of every leaf of the trees, in order."""
    h = hashlib.sha256()
    for tree in trees:
        for _, t in train_mod.named_leaves(tree):
            h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def step_walls(mc: Wav2Vec2Config, params, batch, mesh=None) -> float:
    """Median wall (ms) of DP_TIMED train steps after one warm-up, each
    ending in the loss's read-out and a synchronize; with ``mesh`` on this
    rank's shard."""
    meshed = mesh is not None
    p = train_mod.replicate_params(params, mesh) if meshed else train_mod.clone_params(params)
    opt = train_mod.make_optimizer(TRAIN_CFG)
    state = opt.init(train_mod.trainable_leaves(p, TRAIN_CFG))
    step = train_mod.make_train_step(mc, TRAIN_CFG, opt, mesh)
    b = train_mod.shard_batch(batch, mesh) if meshed else batch
    walls = []
    with matmul_precision_scope(mc.matmul_precision):
        for i in range(DP_TIMED + 1):
            t0 = time.perf_counter()
            float(step(p, state, b)[2])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls[1:])) * 1e3


def allreduce_ms(mesh, params) -> float:
    """Host-clocked ms of the step's all-reduce alone: data_mean over a
    float32 buffer of the trainable leaves' size plus the loss, median of 5
    after one warm-up, each ended by a synchronize."""
    n = sum(t.numel() for t in train_mod.trainable_leaves(params, TRAIN_CFG).values()) + 1
    buf = torch.zeros(n, device="cuda")
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data_mean(mesh, buf)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls[1:])) * 1e3


def dp_world1(model: Wav2Vec2Config, params, batch, data_dir: str):
    """A mesh of one NCCL rank in this process: two ``train`` steps with
    mesh= against two without, in float32 ("highest") and bf16 ("default"),
    under deterministic_training: loss, params and both moments bit-equal,
    the same launches; an unmeshed repeat's equality logged beside it.
    Then the wall per step with and without the mesh and the all-reduce
    alone. Returns (the meshed runs' launches, the timings)."""
    model16 = dataclasses.replace(model, dtype="bfloat16", matmul_precision="default")
    launches = {}
    dist.init_process_group("nccl", init_method=f"file://{data_dir}/dp_nccl_init", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device="cuda")
        for label, mc in (("float32", model), ("bf16", model16)):
            runs = {}
            for run, m, det in (("unmeshed", None, True), ("meshed", mesh, True),
                                ("unmeshed again", None, True),
                                ("unmeshed, default algorithms", None, False)):
                reset_launches()
                with deterministic_training() if det else contextlib.nullcontext([]) as caught:
                    p, state, history = train_mod.train(params, mc, TRAIN_CFG, [batch] * 2,
                                                        mesh=m)
                torch.cuda.synchronize()
                runs[run] = (history[0]["train_loss"], tree_digest(p, state["mu"], state["nu"]),
                             {k: v for k, v in LAUNCHES.items() if v})
                del p, state
                names = sorted({str(w.message).split(" does not have a deterministic")[0][:60]
                                for w in caught if "deterministic" in str(w.message)})
                log(f"dp world 1 {label} {run}: train loss {runs[run][0]!r}, digest "
                    f"{runs[run][1][:16]}; launches {json.dumps(runs[run][2])}; ops without a "
                    f"deterministic implementation: {names or 'none'}")
            want = train_launches(mc, 2)
            check(runs["meshed"][2] == want == runs["unmeshed"][2],
                  f"dp world 1 {label}: launches {runs['meshed'][2]}, expected exactly {want}")
            log(f"dp world 1 {label} (information): bit-equal to the first unmeshed run: the "
                f"repeat {runs['unmeshed again'][:2] == runs['unmeshed'][:2]}, the run with "
                "cuDNN's and PyTorch's default algorithms "
                f"{runs['unmeshed, default algorithms'][:2] == runs['unmeshed'][:2]}")
            check(runs["meshed"][:2] == runs["unmeshed"][:2],
                  f"dp world 1 {label}: the meshed steps' loss, params or moments differ from "
                  "the unmeshed steps'")
            log(f"dp world 1 {label}: two train(mesh=) steps bit-equal to two unmeshed steps "
                "in loss, params and both moments; the same launches")
            for name, c in runs["meshed"][2].items():
                launches[name] = launches.get(name, 0) + c
        # in turns, unmeshed and meshed, as the host's clock drifts
        walls = {"unmeshed": [], "meshed": []}
        for run in ("unmeshed", "meshed", "meshed", "unmeshed"):
            walls[run].append(step_walls(model, params, batch,
                                         mesh if run == "meshed" else None))
        timing = {run: float(np.mean(w)) for run, w in walls.items()}
        timing["allreduce"] = allreduce_ms(mesh, params)
    finally:
        dist.destroy_process_group()
    return launches, timing


def _dp_rank_work(rank: int) -> dict:
    """One of two ranks on the one card (4 of the batch's 8 clips each),
    float32: the all-reduced gradients and loss, and rank 0 also one rank's
    on the whole batch; two ``train`` steps with mesh= (digest of params
    and moments); ``train_synthetic(mesh=)`` on 2 batches; the wall per
    step and the all-reduce alone."""
    model, _, _ = scale_configs()
    params = init_wav2vec2_params(SEED, model, device="cuda")
    batch = train_batch()
    mesh = make_mesh(MeshConfig(), device="cuda")
    out = {"rank": rank}
    reset_launches()
    loss, grads = train_mod.make_loss_and_grads(model, TRAIN_CFG, mesh)(
        params, train_mod.shard_batch(batch, mesh))
    out["loss"] = float(loss)
    out["launches grads"] = {k: v for k, v in LAUNCHES.items() if v}
    if rank == 0:
        loss1, grads1 = train_mod.make_loss_and_grads(model, TRAIN_CFG)(params, batch)
        top = max(float(g.abs().max()) for g in grads1.values())
        out["loss1"] = float(loss1)
        out["grad rel"] = max(
            (float((grads[k] - g).abs().max()) / max(float(g.abs().max()), GRAD_FLOOR * top), k)
            for k, g in grads1.items())
        del grads1
    del grads
    reset_launches()
    p, state, history = train_mod.train(params, model, TRAIN_CFG, [batch] * 2, mesh=mesh)
    torch.cuda.synchronize()
    out["launches train"] = {k: v for k, v in LAUNCHES.items() if v}
    out["history"] = history
    out["digest"] = tree_digest(p, state["mu"], state["nu"])
    del p, state
    reset_launches()
    _, summary = train_synthetic(model, TRAIN_CFG, params=params, clip_seconds=2.0,
                                 batches_per_epoch=2, val_batches_count=1, seed=SEED, mesh=mesh)
    torch.cuda.synchronize()
    out["launches synthetic"] = {k: v for k, v in LAUNCHES.items() if v}
    out["summary"] = summary
    out["wall"] = step_walls(model, params, batch, mesh)
    out["allreduce"] = allreduce_ms(mesh, params)
    return out


def _dp_rank(rank: int, init_file: str, queue) -> None:
    """A spawned rank on cuda:0 of a 2-rank gloo group; its results, or its
    traceback, go to ``queue``."""
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        with highest_precision():
            queue.put((rank, _dp_rank_work(rank), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def dp_two_ranks(model: Wav2Vec2Config, data_dir: str):
    """Two processes on the one card over gloo, float32: the all-reduced
    gradient of every trainable leaf within DP_GRAD_TOL of one rank's on the
    whole batch, the loss within rtol 1e-5; params and both moments after
    two ``train`` steps bit-equal across the ranks, the same history;
    ``train_synthetic(mesh=)``'s summary the same on both (less its wall);
    each run's exact launches. Returns (rank 0's counted launches, the
    ranks' timings)."""
    torch.cuda.empty_cache()  # the card is the ranks' too
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_dp_rank, args=(r, f"{data_dir}/dp_gloo_init", queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out, err = queue.get(timeout=900)
            check(err is None, f"dp two ranks: rank {rank} failed:\n{err}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    r0, r1 = got[0], got[1]
    rel, leaf = r0["grad rel"]
    log(f"check dp two ranks gradients: worst leaf max|dg| / max(max|g|, {GRAD_FLOOR:g} x "
        f"the model's) = {rel:.3e} at {leaf} (limit {DP_GRAD_TOL:g}: two halves' means "
        "averaged against the whole batch's mean, float32 sums in another order)")
    check(rel <= DP_GRAD_TOL, "dp two ranks: an all-reduced gradient is off the one-rank one")
    log(f"check dp two ranks loss: ranks {r0['loss']!r} and {r1['loss']!r}, one rank on the "
        f"whole batch {r0['loss1']!r} (rtol 1e-5)")
    check(r0["loss"] == r1["loss"] and abs(r0["loss"] - r0["loss1"]) <= 1e-5 * abs(r0["loss1"]),
          "dp two ranks: loss")
    # json: the history's val_loss is NaN (no validation batches), never equal to itself
    check(r0["digest"] == r1["digest"]
          and json.dumps(r0["history"]) == json.dumps(r1["history"]),
          "dp two ranks: params or moments differ across the ranks after two steps")
    log(f"dp two ranks: after two train(mesh=) steps params and both moments bit-equal "
        f"across the ranks (sha256 {r0['digest'][:16]}), history {json.dumps(r0['history'])}")
    s0, s1 = ({k: v for k, v in r["summary"].items() if k != "train_wall_s"} for r in (r0, r1))
    check(s0 == s1, f"dp two ranks: train_synthetic summaries differ: {s0} and {s1}")
    check(all(np.isfinite(s0[k]) for k in ("final_train_loss", "final_val_loss")),
          "dp two ranks: train_synthetic losses not finite")
    log(f"dp two ranks train_synthetic(mesh=): the same summary on both ranks (walls "
        f"{r0['summary']['train_wall_s']} and {r1['summary']['train_wall_s']} s): "
        f"{json.dumps({k: v for k, v in s0.items() if k != 'example_pairs'})}")
    counted = {}
    for r in (r0, r1):
        for key, want in (("launches grads", train_launches(model, 1)),
                          ("launches train", train_launches(model, 2)),
                          ("launches synthetic", train_launches(model, 2, forwards=2))):
            check(r[key] == want, f"dp two ranks rank {r['rank']} {key}: {r[key]}, expected "
                  f"exactly {want}")
    for key in ("launches grads", "launches train", "launches synthetic"):
        for name, c in r0[key].items():
            counted[name] = counted.get(name, 0) + c
    log(f"dp two ranks: {wall:.1f} s with the spawn; each rank's launches exact "
        f"({json.dumps(r0['launches train'])} per two steps)")
    return counted, [(r["wall"], r["allreduce"]) for r in (r0, r1)]


def dp_dryrun() -> None:
    """``asr_shap_torch.dryrun.dryrun_multichip(2, device="cuda")``: its four
    parts on two ranks (gloo on cuda:0 where the host has one card)."""
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        torch.cuda.empty_cache()  # the card is the dry run's ranks' too
        res = dryrun_multichip(2, device="cuda")
    for line in out.getvalue().splitlines():
        log(f"dp dryrun: {line}")
    log(f"dp dryrun: {time.perf_counter() - t0:.1f} s with the spawn; rank 0 "
        f"{json.dumps(res)}")


def phase_dp(data_dir: str, smi: str) -> dict:
    """Data-parallel training of Wav2Vec2-base at full width with the kernel
    impls, on the training phase's batch (8 clips of 2 s): one NCCL rank
    against no mesh (float32 and bf16, bit-equal), two gloo ranks on the
    card against one rank, the dryrun twin; the wall per step and the
    all-reduce alone. Returns the JSON line's launches_dp."""
    t0 = time.perf_counter()
    log(smi)
    model, _, _ = scale_configs()
    batch = train_batch()
    params = init_wav2vec2_params(SEED, model, device="cuda")
    launches, one = dp_world1(model, params, batch, data_dir)
    del params
    log(f"dp phase: world 1 done at {time.perf_counter() - t0:.1f} s")
    counted, two = dp_two_ranks(model, data_dir)
    for name, c in counted.items():
        launches[name] = launches.get(name, 0) + c
    log(f"dp phase: two ranks done at {time.perf_counter() - t0:.1f} s")
    dp_dryrun()
    log(f"timing dp ({smi}; one card, so no scale-out speed-up: the two ranks share it): "
        f"one NCCL rank, wall per step unmeshed {one['unmeshed']:.1f} ms, meshed "
        f"{one['meshed']:.1f} ms (8 clips; each the mean of two medians of {DP_TIMED}, taken "
        f"in turns), all-reduce of the gradients alone "
        f"{one['allreduce']:.2f} ms; two gloo ranks on cuda:0, wall per step "
        f"{two[0][0]:.1f} / {two[1][0]:.1f} ms (4 clips each), all-reduce through gloo's host "
        f"copies {two[0][1]:.1f} / {two[1][1]:.1f} ms (host clock, median of 5)")
    log(f"dp phase: {time.perf_counter() - t0:.1f} s; launches_dp "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


# ---------------------------------------------------------------- draw chunks, remat

CHUNK_DRAWS = 8
# (draw_chunk, output_chunk) of each setting; draw_chunk 1 is the yardstick
CHUNK_SETTINGS = ((1, 0), (2, 0), (4, 0), (8, 64))
# device memory of one cotangent row in flight (a chunk's draws x a slice's
# rows), from the float32 paths' one-draw peaks at 149 rows (9.08 GiB base,
# 11.48 GiB conformer): the predicted peak of a setting is rows x this
CHUNK_ROW_GIB = {"base float32": 9.08 / 149, "base bf16": 9.18 / 149,
                 "conformer float32": 11.48 / 149}
# the activations a draw keeps over the encoder layers without remat, from
# the remat phase's one-draw peaks off and "full" on the card (base 9.09 -
# 9.04 GiB, conformer 11.28 - 10.86); bf16 taken as float32's
CHUNK_KEPT_GIB = {"base float32": 0.05, "base bf16": 0.05, "conformer float32": 0.42}
CHUNK_PEAK_LIMIT_GIB = 70.0


def chunk_inputs(test_set, n: int = CHUNK_DRAWS):
    """The 5 dB clip normalized, ``reference_draw``'s background and ``n``
    explicit draws, on the card."""
    x = zero_mean_unit_var(torch.from_numpy(test_set[1]["audio"]).cuda())
    bg = 0.01 * torch.randn((5, N_SAMPLES), generator=torch.Generator().manual_seed(1)).cuda()
    return x, bg, sample_draws(torch.Generator().manual_seed(8), n, 5)


def chunk_k1_596(base: Wav2Vec2Config) -> None:
    """K1 at 596 cotangent rows (draw_chunk 4 x 149), the feature encoder's
    largest layer (xbar 596 x 9,599 x 512, past 2^31 elements), float32
    and bf16, against its plain version on the same inputs: phase 2's
    tolerances (float32 atol 5e-4 of max|ybar|, rtol 1e-4; bf16 one bf16
    ulp), taken over slices of 64 rows to bound the memory."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    k, s, ci, co, ti, to = max(k1_main_shapes(base, 596), key=lambda r: r[4])
    for dtype in (torch.float32, BF16):
        ybar, w = (t.to(dtype) for t in k1_inputs(gen, 596, k, ci, co, to))
        reset_launches()
        got = k1.conv1d_dgrad(ybar, w, s, ti)
        torch.cuda.synchronize()
        check(sum(LAUNCHES.values()) == 1, f"chunk K1 596: launches {dict(LAUNCHES)}")
        want = k1.conv1d_dgrad_plain(ybar, w, s, ti)
        if dtype == torch.float32:
            atol, rtol = 5e-4 * float(ybar.abs().max()), 1e-4
        else:
            atol, rtol = BF16_ATOL_REL * float(want.abs().max()), BF16_RTOL
        err = worst = 0.0
        for i in range(0, 596, 64):
            e = (got[i:i + 64].float() - want[i:i + 64].float()).abs()
            err = max(err, float(e.max()))
            worst = max(worst, float((e - rtol * want[i:i + 64].float().abs()).max()))
        log(f"check chunk K1 {k1_name(dtype)} B=596 K={k} s={s} T_in={ti} T_out={to} "
            f"(xbar {596 * ti * ci:,} elements): max_abs_err={err:.3e} (atol {atol:.3e}, "
            f"rtol {rtol:g})")
        check(bool(torch.isfinite(got).all()) and worst <= atol,
              f"chunk K1 596 {dtype}: exceeds tolerance")
        del ybar, w, got, want
        torch.cuda.empty_cache()


def chunk_gate(label: str, mc: Wav2Vec2Config, phi, phi1, phi32) -> str:
    """phi held to draw_chunk 1's ``phi1`` (float32: within 1e-5 of
    max|phi|, the same products summed in another order; bf16: no further
    from the float32 draw_chunk 1 phi ``phi32`` than ``phi1`` is, x 1.25).
    Returns the gate's text."""
    scale = float(phi1.abs().max())
    err = float((phi - phi1).abs().max())
    if mc.dtype == "float32":
        gate = f"max|dphi| / max|phi| = {err / scale:.3e} (limit 1e-5)"
        check(err <= 1e-5 * scale, f"{label}: {gate}")
        return gate
    d_c, d_1 = float((phi - phi32).norm()), float((phi1 - phi32).norm())
    gate = (f"|phi - phi32 (draw_chunk 1)| = {d_c:.6e} against bf16 draw_chunk 1's "
            f"{d_1:.6e} (ratio {d_c / d_1:.4f}, limit 1.25); max|dphi| / max|phi| "
            f"against bf16 draw_chunk 1 = {err / scale:.3e} (information)")
    check(d_c <= 1.25 * d_1, f"{label}: {gate}")
    return gate


def chunk_path(label: str, mc: Wav2Vec2Config, params, x, bg, draws, smi: str,
               phi32=None) -> tuple:
    """expected_phi over the CHUNK_DRAWS draws at each CHUNK_SETTINGS entry,
    with remat on (the default) and then off: the exact launches
    (``expected_launches_eg``, no transcript), wall per draw and peak device
    memory each way, each beside its prediction, the device-busy share
    with remat on; phi at every setting and either way through
    ``chunk_gate`` against draw_chunk 1's with remat on, and with remat off
    also against the same setting's with remat on (information). Each
    setting first runs one chunk under the profiler (``profile_calls``; two
    draws at draw_chunk 1): its device-busy time per draw, and the warm-up
    of the setting's allocations; the busy share is that time over the
    unprofiled run's wall per draw. Returns (phi at draw_chunk 1 with remat
    on, launches)."""
    t_out = mc.frames_for_samples(N_SAMPLES)
    launches: dict = {}
    phi1 = None
    torch.cuda.empty_cache()
    for dc, oc in CHUNK_SETTINGS:
        ec = ExplainerConfig(nsamples=CHUNK_DRAWS, draw_chunk=dc, output_chunk=oc,
                             num_background=5)
        rows = dc * (oc if 0 < oc < t_out else t_out)
        predicted = rows * CHUNK_ROW_GIB[label]
        check(predicted <= CHUNK_PEAK_LIMIT_GIB, f"chunk {label}: {predicted:.1f} GiB predicted")
        f = make_explained_fn(params, mc, ec)
        n = dc if dc > 1 else 2
        one = (draws[0][:n], draws[1][:n])
        ec1 = dataclasses.replace(ec, nsamples=n)
        busy = sum(profile_calls(lambda: expected_phi(f, x, bg, config=ec1, draws=one), n,
                                 tag=f"chunk profile {label} draw_chunk {dc}",
                                 host_ops=False).values()) or None
        phi_on = None
        for remat in (True, False):
            ec_r = dataclasses.replace(ec, remat=remat)
            what = f"chunk {label} draw_chunk {dc} output_chunk {oc} remat {'on' if remat else 'off'}"
            want = expected_launches_eg(PipelineConfig(model=mc, explainer=ec_r), 1,
                                        transcripts=0)
            f = make_explained_fn(params, mc, ec_r)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phi = expected_phi(f, x, bg, config=ec_r, draws=draws)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / CHUNK_DRAWS
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = {k: c for k, c in LAUNCHES.items() if c}
            check(got == want, f"{what}: launches {got}, {want} expected")
            for name, c in got.items():
                launches[name] = launches.get(name, 0) + c
            check(bool(torch.isfinite(phi).all()) and tuple(phi.shape) == (N_SAMPLES, t_out),
                  f"{what}: phi {tuple(phi.shape)} not finite")
            if phi1 is None:
                phi1, gate = phi, "yardstick"
            else:
                gate = chunk_gate(what, mc, phi, phi1, phi32)
            if remat:
                phi_on, extra = phi, ("device busy " + (
                    "not measured" if busy is None
                    else f"{busy:.1f} ms per draw, {100 * busy / wall:.1f}% of the wall"))
                pred = f"predicted {predicted:.1f}"
            else:
                err = float((phi - phi_on).abs().max()) / float(phi_on.abs().max())
                extra = (f"device busy not measured; against remat on: max|dphi| / max|phi| = "
                         f"{err:.3e}, {'bit-equal' if torch.equal(phi, phi_on) else 'not bit-equal'}"
                         f" (information)")
                pred = (f"predicted {predicted + dc * CHUNK_KEPT_GIB[label]:.1f}: remat on's "
                        f"+ {dc} x {CHUNK_KEPT_GIB[label]:.2f}")
            log(f"{what}: {rows} cotangent rows in flight; wall per draw {wall:.1f} ms "
                f"({CHUNK_DRAWS} draws); {extra}; peak {peak:.2f} GiB ({pred}); launches "
                f"exact {json.dumps(got)}; {gate}; {smi}")
            del phi
        del phi_on
    return phi1, launches


def phase_chunk(model: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig, test_set,
                smi: str) -> dict:
    """Expected gradients with a chunk's draws as one batch, at 48,000
    samples (T_out = 149), full width, random weights from SEED, the kernel
    impls, 8 explicit draws: base float32 ("highest"), base bf16
    ("default") and the rel-pos-large conformer float32, each at
    ``CHUNK_SETTINGS`` with remat on and off (``chunk_path``); K1 at 596
    rows against its plain
    version first. Returns the launches by kernel (the JSON line's
    launches_chunk)."""
    t0 = time.perf_counter()
    chunk_k1_596(model)
    x, bg, draws = chunk_inputs(test_set)
    launches: dict = {}
    params = init_wav2vec2_params(SEED, model, device="cuda")
    phi32, got = chunk_path("base float32", model, params, x, bg, draws, smi)
    launches.update(got)
    model16 = dataclasses.replace(model, dtype="bfloat16", matmul_precision="default")
    with matmul_precision_scope("default"):
        _, got = chunk_path("base bf16", model16, cast_params_for_compute(params, "bfloat16"),
                            x, bg, draws, smi, phi32)
    launches.update(got)
    del params, phi32
    cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
    _, got = chunk_path("conformer float32", conformer, cparams, x, bg, draws, smi)
    launches.update(got)
    del cparams
    torch.cuda.empty_cache()
    log(f"chunk phase: {time.perf_counter() - t0:.1f} s; launches_chunk "
        f"{json.dumps(launches)}")
    return launches


def remat_explainer(label: str, mc: Wav2Vec2Config, params, x, bg, smi: str) -> None:
    """phi of one draw (output_chunk 0) with remat off, "full" and "dots",
    in turns twice (off, full, dots, dots, full, off) after an untimed
    draw: within 1e-6 of max|phi| of remat off, bit-equality said; the
    mean wall of the two draws and the peak each way. cuDNN's deterministic
    algorithms hold the first conv layer's dgrad to one summation order."""
    draws = sample_draws(torch.Generator().manual_seed(9), 1, 5)
    modes = (("remat off", False, "full"), ("remat 'full'", True, "full"),
             ("remat 'dots'", True, "dots"))
    walls: dict = {}
    peaks: dict = {}
    phis: dict = {}
    with deterministic_convs():
        for i, (what, remat, policy) in enumerate(modes[1:2] + modes + modes[::-1]):
            m = dataclasses.replace(mc, remat_policy=policy)
            ec = ExplainerConfig(nsamples=1, draw_chunk=1, output_chunk=0, num_background=5,
                                 remat=remat)
            f = make_explained_fn(params, m, ec)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            phi = expected_phi(f, x, bg, config=ec, draws=draws)
            torch.cuda.synchronize()
            if i == 0:
                continue  # the untimed draw
            walls.setdefault(what, []).append((time.perf_counter() - t0) * 1e3)
            peaks[what] = max(peaks.get(what, 0.0), torch.cuda.max_memory_allocated() / 2**30)
            phis.setdefault(what, phi)
    ref = phis["remat off"]
    for what, _, policy in modes:
        phi = phis[what]
        if what == "remat off":
            gate = "yardstick"
        else:
            scale, err = float(ref.abs().max()), float((phi - ref).abs().max())
            gate = (f"max|dphi| / max|phi| = {err / scale:.3e} (limit 1e-6), "
                    f"{'bit-equal' if torch.equal(phi, ref) else 'not bit-equal'}")
            check(err <= 1e-6 * scale, f"remat {label} {policy}: {gate}")
        w = walls[what]
        log(f"remat {label} explainer {what}: wall per draw {float(np.mean(w)):.1f} ms "
            f"({w[0]:.1f}, {w[1]:.1f} in turns), peak {peaks[what]:.2f} GiB; {gate}; {smi}")


def remat_train(cmc: Wav2Vec2ConformerConfig, cparams, batch, smi: str) -> None:
    """One float32 conformer training step's loss and gradients with remat
    (``train.make_loss_and_grads``, whose loss asks for it: 2 K2f launches
    per layer) and without (the same loss at remat=False): wall (median of
    3 after one warm-up) and peak each way, and each leaf's gradient within
    1e-6 of its max|g| (floored at GRAD_FLOOR of the model's), under
    deterministic algorithms."""
    tcfg = TRAIN_CFG
    leaves_of = train_mod.trainable_leaves

    def without(params, batch):
        leaves = leaves_of(params, tcfg)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            lengths = batch["audio_lengths"]
            logits = w2v2_conformer_logits(params, cmc, zero_mean_unit_var(batch["audio"], lengths),
                                           lengths=lengths, remat=False)
            loss = ctc_loss(logits, feature_lengths(cmc, lengths), batch["labels"],
                            batch["label_lengths"])
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                               for (k, t), g in zip(leaves.items(), grads)}

    runs = {"remat on": train_mod.make_loss_and_grads(cmc, tcfg), "remat off": without}
    out = {}
    layers = cmc.num_hidden_layers
    with matmul_precision_scope(cmc.matmul_precision), deterministic_training():
        for label, fn in runs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            loss, grads = fn(cparams, batch)
            torch.cuda.synchronize()
            fwd = LAUNCHES["flash_fwd_bias"]
            check(fwd == layers * (2 if label == "remat on" else 1),
                  f"remat train {label}: flash_fwd_bias launched {fwd} times")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(cparams, batch)[0].item()
                walls.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[label] = (float(loss), grads)
            log(f"remat train conformer {label}: wall per step {float(np.median(walls)):.1f} ms "
                f"(median of 3 after one), peak {peak:.2f} GiB, loss {float(loss):.6f}, "
                f"{fwd} flash_fwd_bias launches; {smi}")
    (l_on, g_on), (l_off, g_off) = out["remat on"], out["remat off"]
    top = max(float(g.abs().max()) for g in g_off.values())
    worst, equal = (0.0, ""), True
    for name, w in g_off.items():
        err = float((g_on[name] - w).abs().max())
        rel = err / max(float(w.abs().max()), GRAD_FLOOR * top)
        equal = equal and torch.equal(g_on[name], w)
        worst = max(worst, (rel, name))
    log(f"check remat train conformer gradients: {len(g_off)} leaves, worst max|dg| / "
        f"max(max|g|, {GRAD_FLOOR:g} x {top:.3e}) = {worst[0]:.3e} at {worst[1]} (limit 1e-6); "
        f"{'bit-equal' if equal else 'not bit-equal'}; loss {l_on:.6f} / {l_off:.6f}")
    check(worst[0] <= 1e-6, f"remat train: gradients {worst}")
    check(abs(l_on - l_off) <= 1e-6 * abs(l_off), "remat train: losses differ")


def phase_remat(model: Wav2Vec2Config, conformer: Wav2Vec2ConformerConfig, test_set,
                smi: str) -> None:
    """remat on the explainer (base and rel-pos-large conformer, float32,
    full width) and on the float32 conformer's training step (the training
    phase's batch)."""
    t0 = time.perf_counter()
    x, bg, _ = chunk_inputs(test_set, 0)
    params = init_wav2vec2_params(SEED, model, device="cuda")
    remat_explainer("base", model, params, x, bg, smi)
    del params
    cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
    remat_explainer("conformer", conformer, cparams, x, bg, smi)
    remat_train(conformer, cparams, train_batch(), smi)
    del cparams
    torch.cuda.empty_cache()
    log(f"remat phase: {time.perf_counter() - t0:.1f} s")


def kernel_rows(out, errs, extra, launches):
    """The JSON line's entries: one per kernel, base path's first; ``extra``
    adds fields to a kernel's entry."""
    return [{
        "name": BF16_NAMES.get(name, name), "route": "cuda", "source": ROUTES[name][0],
        "replaces": ROUTES[name][1], "launches": launches[name],
        "max_abs_err": errs[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"], "device_ms": row["device_ms"],
        **extra.get(name, {}),
    } for name, row in out.items()]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a "
              "CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        log(f"clock: {phase} phase done at {time.perf_counter() - t_start:.1f} s")

    smi, build_fields = phase_build()
    model = Wav2Vec2Config(attention_impl="pallas", conv_impl="pallas")
    conformer = Wav2Vec2ConformerConfig(attention_impl="pallas", conv_impl="pallas")
    explainer = ExplainerConfig(nsamples=NSAMPLES, method="grad", aggregation="max",
                                draw_chunk=1, output_chunk=0, num_background=5)
    # TF32 off for matmuls and cuDNN convs: kernels, plain versions and
    # yardsticks all run in float32
    with highest_precision(), tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        errs, extra = phase_checks(model)
        full_errs, full_extra = phase_checks_full_bias(conformer)
        errs.update(full_errs)
        extra.update(full_extra)
        test_set = make_test_set()
        mark("checks")

        cfg = PipelineConfig(model=model, explainer=explainer, seed=SEED,
                             data_dir=f"{data_dir}/base")
        params = init_wav2vec2_params(SEED, model, device="cuda")
        base_archive = f"{data_dir}/base_pallas.npz"
        save_params(base_archive, params, model)
        launches = phase_pipeline("base", cfg, params, test_set, BASE_KERNELS)
        phase_reference(cfg, params, test_set)
        out, f32_per_draw = phase_timing(cfg, params, test_set)
        mark("base")
        del params

        ccfg = PipelineConfig(model=conformer, explainer=explainer, seed=SEED,
                              data_dir=f"{data_dir}/conformer")
        cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
        claunches = phase_pipeline("conformer", ccfg, cparams, test_set, CONFORMER_KERNELS)
        phase_reference_conformer(ccfg, cparams, test_set, data_dir)
        cout, c32_per_draw = phase_timing_conformer(ccfg, cparams, test_set, out["conv_dgrad"])
        mark("conformer")
        del cparams
        c32_cli_records = phase_cli(base_archive, data_dir)
        mark("cli")
        model16 = Wav2Vec2Config(dtype="bfloat16", matmul_precision="default",
                                 attention_impl="pallas", conv_impl="pallas")
        b_errs, b_extra, blaunches, bout = phase_bf16(model16, explainer, test_set, data_dir,
                                                      f32_per_draw)
        errs.update(b_errs)
        mark("bf16")
        extra.update(b_extra)
        conformer16 = dataclasses.replace(conformer, dtype="bfloat16",
                                          matmul_precision="default")
        c_errs, c_extra, c16launches, c16out = phase_bf16_conformer(
            conformer16, explainer, test_set, data_dir, c32_per_draw, c32_cli_records)
        errs.update(c_errs)
        mark("bf16 conformer")
        extra.update(c_extra)
        phase_explainers(model, conformer, explainer, test_set, data_dir, smi)
        mark("explainers")
        phase_compare(model, base_archive, data_dir, smi)
        mark("compare")
        for name, count in phase_mel_conformer(test_set, smi).items():
            extra[name] = {**extra.get(name, {}), "launches_mel": count}
        mark("mel")
        trained = phase_train(model, conformer, base_archive, data_dir, smi)
        mark("train")
        for name in ROUTES:
            extra[name] = {**extra.get(name, {}), "launches_train": trained.get(name, 0)}
        scaled = phase_scale(base_archive, data_dir, smi)
        mark("scale")
        for name in ROUTES:
            extra[name] = {**extra.get(name, {}), "launches_scale": scaled.get(name, 0)}
        dp = phase_dp(data_dir, smi)
        mark("dp")
        for name in ROUTES:
            extra[name] = {**extra.get(name, {}), "launches_dp": dp.get(name, 0)}
        chunked = phase_chunk(model, conformer, test_set, smi)
        mark("chunk")
        for name in ROUTES:
            extra[name] = {**extra.get(name, {}), "launches_chunk": chunked.get(name, 0)}
        phase_remat(model, conformer, test_set, smi)
        mark("remat")
        for name, fields in build_fields.items():
            extra[name] = {**extra.get(name, {}), **fields}
        kernels = (kernel_rows(out, errs, extra, launches)
                   + kernel_rows(cout, errs, extra, claunches)
                   + kernel_rows(bout, errs, extra, blaunches)
                   + kernel_rows(c16out, errs, extra, c16launches))
    log(smi)  # again beside the numbers, for a reader of the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
