#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr_shap_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Two paths are driven, each through run_shap_pipeline at full width with
random weights from a seed: the base path (Wav2Vec2-base, kernels K1-K4)
and the conformer slice (Wav2Vec2-Conformer rel-pos-large, kernels K1 and
the full-bias flash kernels K2f, K3b, K4f). Phases, each reported on its
own lines:

1. the card's name and power limit (nvidia-smi); build every kernel from
   asr_shap_torch/csrc with nvcc, one process per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, float32,
   at its path's shapes, with the tolerance stated beside it (the full-bias
   kernels with a rel-pos-like bias, and with the same bias masked; the
   flash forward also at 100 and 500 keys; K3 and K4, and K3b and K4f with
   a rel-pos-like bias, also at one and 37 cotangent rows per residual row,
   five clips with a mask length each, 100 and 500 keys and D = 32; K1, K3
   and K4, K3b and K4f and their plain versions also against float64; K2
   also at the sweep's batched shapes, 8 clips, no bias, T = 149 and 312,
   D = 64 and 32);
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
   (K1 once per eligible conv layer, the flash kernels once per encoder
   layer); its "launches" is the count from its path's pipeline run of
   phase 3 (the command line's counts are logged, "cli" lines). Every kernel (K1, the flash forward K2 and K2f, the flash
   backward K3, K4, K3b and K4f) runs on the tensor cores in 3xTF32, so
   its bound is three TF32 products per float32 product at the TF32 peak,
   or its bytes ("operations (3xTF32)" or "bytes"); the log gives its
   float32 FMA bound beside it. The flash backward's yardstick is SDPA's
   backward alone on the same inputs (its forward run once, outside the
   timing); forward plus backward is logged beside it.

Prints one JSON line of per-kernel numbers, then as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from asr_shap_torch import cli
from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    ExplainerConfig,
    MetricConfig,
    PipelineConfig,
    Wav2Vec2Config,
    Wav2Vec2ConformerConfig,
)
from asr_shap_torch.core.device import highest_precision
from asr_shap_torch.core.params_io import load_config, load_params, save_params
from asr_shap_torch.core.store import AttributionStore, key_for
from asr_shap_torch.explain.expected_gradients import expected_phi, sample_draws
from asr_shap_torch.kernels import LAUNCHES, build_all, reset_launches
from asr_shap_torch.kernels import _build
from asr_shap_torch.kernels import conv_dgrad as k1
from asr_shap_torch.kernels import flash_attention as fa
from asr_shap_torch.metrics.eta_raw import eta_raw
from asr_shap_torch.metrics.wer import wer
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params
from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params
from asr_shap_torch.ops.attention import rel_shift
from asr_shap_torch.pipeline.run_shap import run_shap_pipeline

N_SAMPLES = 48_000
NSAMPLES = 4
SEED = 0
CONFORMER_ARCHIVE = "artifacts/params_synthetic_conformer.npz"
STUDY_ARCHIVE = "artifacts/params_synthetic_study.npz"
STUDY_SAMPLES = 100_000  # the study archive's clips, as its committed studies
# the kernels each path must launch, and the TPU kernel each one replaces
BASE_KERNELS = ("conv_dgrad", "flash_fwd", "flash_dq", "flash_dkv")
CONFORMER_KERNELS = ("conv_dgrad", "flash_fwd_bias", "flash_dq_dbias", "flash_dkv_bias")
ROUTES = {
    "conv_dgrad": ("asr_shap_torch/csrc/conv_dgrad.cu", "asr_shap/kernels/conv_dgrad.py:150"),
    "flash_fwd": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:282"),
    "flash_fwd_bias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:118"),
    "flash_dq_dbias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:247"),
    "flash_dkv_bias": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:282"),
}
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
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
    from torch.profiler over ``iters`` calls of ``fn`` after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
        log(f"profiler saw {count} launches of {kernel} of {iters}; profiling again")
    raise CheckFailed(f"profiler saw under half the launches of {kernel} in {tries} tries")


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

def k1_main_shapes(cfg: Wav2Vec2Config, rows: int):
    """(K, s, C_in, C_out, T_in, T_out) of each eligible feature-encoder
    layer at N_SAMPLES, for ``rows`` cotangent rows."""
    out, t = [], N_SAMPLES
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
    """A [BH, T, T] full bias shaped like the conformer's: q . random
    position projections over 2T-1 relative positions, rel-shifted and
    scaled by D^-1/2; ``masked`` adds -1e9 on the last 29 keys."""
    bh, t, d = q.shape
    p_proj = torch.randn((2 * t - 1, bh, d), generator=gen, device="cuda")
    bias = rel_shift(torch.einsum("bhtd,rhd->bhtr", q[None], p_proj))[0] * d ** -0.5
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
            if "Used" in line or "spill" in line or "entry function" in line:
                log(f"ptxas {name}: {line.strip()}")
    return smi


def k1_float64_check(gen, b, k, s, ci, co, ti, to) -> dict:
    """K1 and its float32 plain version against the plain version in
    float64, at one main-path shape: the accuracy of 3xTF32 on the card's
    tensor cores beside float32's. Each is held to K1's tolerance, and K1
    to at most twice the plain version's error."""
    ybar, w = k1_inputs(gen, b, k, ci, co, to)
    want = k1.conv1d_dgrad_plain(ybar.double(), w.double(), s, ti)
    errs = {}
    for key, got in (("kernel", k1.conv1d_dgrad(ybar, w, s, ti)),
                     ("plain", k1.conv1d_dgrad_plain(ybar, w, s, ti))):
        errs[key] = compare(f"conv_dgrad B={b} K={k} s={s} T_out={to}: {key} (float32) "
                            f"vs float64", got.double(), want, 5e-4, 1e-4,
                            "K1's tolerance, against the exact sum")
        del got
    log(f"conv_dgrad vs float64: kernel {errs['kernel']:.3e}, float32 plain "
        f"{errs['plain']:.3e} (ratio {errs['kernel'] / errs['plain']:.2f})")
    # as the CPU test holds the 3xTF32 emulation: at most 2x float32's error
    check(errs["kernel"] <= 2 * errs["plain"],
          "conv_dgrad: 3xTF32 error over 2x float32's against float64")
    return errs


def check_fwd_lengths(gen, h: int, d: int, full: bool) -> float:
    """K2 (``full``: K2f) at both block heights against its plain version at
    T = 100 (one partial chunk; some warps hold no key) and T = 500 (three
    chunks of keys, so the online rescale runs), with the first 200 keys
    and the last 29 masked to -1e9 (for the full bias, on every other query
    row): a row's first chunk is all masked, so its rescale factor is 0."""
    err = 0.0
    name = "flash_fwd_bias" if full else "flash_fwd"
    for t in (100, 500):
        q, k, v, bias, _ = flash_inputs(gen, 1, h, t, d, 1, not full)
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
                err = max(err, compare(
                    f"{name} {part} BH={h} T={t} rows/block={rows} masked", x, y, 2e-5, 2e-4,
                    f"float32 softmax over {t} keys, another summation order"))
    return err


def check_fwd_sweep_shapes(gen) -> float:
    """K2 at the sweep's batched forward: 8 clips of one length, no bias,
    T = 149 (48,000 samples) and 312 (100,000), with the base model's 12
    heads of 64 and the study archive's 3 heads of 32; both block heights."""
    err = 0.0
    for h, d in ((12, 64), (3, 32)):
        for t in (149, 312):
            q, k, v, _, _ = flash_inputs(gen, 8, h, t, d, 1, False)
            want = fa.flash_fwd_plain(q, k, v, None, h)
            fa._check(q, k, v, None, h)
            for rows in fa.FWD_ROWS:
                got = fa._fwd_launch(q, k, v, None, h, rows)
                for part, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
                    err = max(err, compare(
                        f"flash_fwd {part} B=8 H={h} T={t} D={d} rows/block={rows} (sweep)",
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


def bwd_kernel_names(full: bool):
    """The counters (and JSON names) of the dq and dk/dv kernels: K3b and
    K4f for a full bias, else K3 and K4."""
    return ("flash_dq_dbias", "flash_dkv_bias") if full else ("flash_dq", "flash_dkv")


def check_bwd_shapes(gen, h: int, full: bool = False) -> dict:
    """K3 and K4 (``full``: K3b and K4f, with a rel-pos-like bias) against
    their plain versions where the grouped kernels can break, each case
    unmasked and masked: one cotangent row per residual row (N = BH); 37
    rows per residual row (the last group of 8 warps part empty); five
    clips with a mask length each; 100 keys (a partial chunk) and 500 keys
    with the last 200 masked (several chunks); and D = 32. With a full bias
    d(bias) is compared too, and must be exactly 0 on masked keys."""
    why = "float32 backward sums over T keys, another summation order"
    dq_name, dkv_name = bwd_kernel_names(full)
    errs = {dq_name: 0.0, dkv_name: 0.0}
    # (clips B, keys T, head dim D, cotangent rows per residual row, mask lengths)
    cases = [(1, 149, 64, 1, [120]), (1, 149, 64, 37, [120]),
             (5, 149, 64, 8, [149, 131, 100, 77, 16]), (1, 100, 64, 8, [71]),
             (1, 500, 64, 8, [300]), (1, 149, 32, 8, [120])]
    for b, t, d, v_rows, lengths in cases:
        for masked in (False, True):
            q, k, v, _, g = flash_inputs(gen, b, h, t, d, v_rows, False)
            if full:
                bias = full_bias_lengths(gen, q, h, lengths if masked else [])
            else:
                bias = mask_lengths(b, t, lengths) if masked else None
            o, lse = fa.flash_fwd_plain(q, k, v, bias, h)
            label = f"B={b} T={t} D={d} N={g.shape[0]} ({v_rows} per residual row) mask={masked}"
            dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, h)
            dq_p, dd_p, dbias_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
            errs[dq_name] = max(errs[dq_name],
                                compare(f"{dq_name} dq {label}", dq, dq_p, 5e-5, 5e-4, why),
                                compare(f"{dq_name} dd {label}", dd, dd_p, 5e-5, 5e-4, why))
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
                                 compare(f"{dkv_name} dk {label}", dk, dk_p, 5e-5, 5e-4, why),
                                 compare(f"{dkv_name} dv {label}", dv, dv_p, 5e-5, 5e-4, why))
            del q, k, v, g, bias, o, lse, dd_p, dk, dv, dk_p, dv_p
    return errs


def bwd_float64_check(gen, h: int, d: int, t: int, rows: int, full: bool = False) -> dict:
    """K3 and K4 (``full``: K3b and K4f, with a rel-pos-like bias) and their
    float32 plain versions against the plain versions in float64, at the
    path's shape: the accuracy of 3xTF32 on the card's tensor cores beside
    float32's. Each is held to the backward's tolerance, and dq, dk, dv
    (and d(bias)) each to at most twice the plain version's error. The
    float32 runs take o, lse and dd from the float64 runs, rounded to
    float32."""
    q, k, v, _, g = flash_inputs(gen, 1, h, t, d, rows, False)
    bias = rel_pos_bias(gen, q, False) if full else None
    q64, k64, v64, g64 = (x.double() for x in (q, k, v, g))
    b64 = None if bias is None else bias.double()
    o64, lse64 = fa.flash_fwd_plain(q64, k64, v64, b64, h)
    dq64, dd64, db64 = fa.flash_dq_plain(q64, k64, v64, o64, lse64, g64, b64, h)
    dk64, dv64 = fa.flash_dkv_plain(q64, k64, v64, lse64, g64, dd64, b64, h)
    o, lse, dd = o64.float(), lse64.float(), dd64.float()
    runs = {"kernel": (fa.flash_dq, fa.flash_dkv),
            "plain": (fa.flash_dq_plain, fa.flash_dkv_plain)}
    why = "the backward's tolerance, against the exact sum"
    label = "flash backward, full bias," if full else "flash backward"
    names = ("dq", "dk", "dv") + (("dbias",) if full else ())
    errs = {}
    for key, (dq_fn, dkv_fn) in runs.items():
        dq, _, dbias = dq_fn(q, k, v, o, lse, g, bias, h)
        dk, dv = dkv_fn(q, k, v, lse, g, dd, bias, h)
        outs = {"dq": (dq, dq64), "dk": (dk, dk64), "dv": (dv, dv64), "dbias": (dbias, db64)}
        for name in names:
            got, want = outs[name]
            errs[key, name] = compare(f"{label} {name} N={g.shape[0]} T={t}: {key} "
                                      f"(float32) vs float64", got.double(), want,
                                      5e-5, 5e-4, why)
        del dq, dk, dv, dbias, outs
    for name in names:
        kern, plain = errs["kernel", name], errs["plain", name]
        log(f"{label} {name} vs float64: kernel {kern:.3e}, float32 plain "
            f"{plain:.3e} (ratio {kern / plain:.2f})")
        check(kern <= 2 * plain, f"{label} {name}: 3xTF32 error over 2x float32's "
              "against float64")
    # each JSON row takes the largest error over its kernel's outputs
    dq_name, dkv_name = bwd_kernel_names(full)
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


def phase_checks_full_bias(cfg: Wav2Vec2ConformerConfig):
    """K2f, K3b and K4f against their plain versions at the conformer
    slice's shapes: BH = 16, T = 149, D = 64, N = 149 * 16 = 2,384; K3b and
    K4f also over ``check_bwd_shapes``'s sweep and against float64."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rows = cfg.frames_for_samples(N_SAMPLES)
    h, d, t = cfg.num_attention_heads, cfg.head_dim, rows
    errs = {key: 0.0 for key in ("flash_fwd_bias", "flash_dq_dbias", "flash_dkv_bias")}
    errs["flash_fwd_bias"] = check_fwd_lengths(gen, h, d, True)
    why_f = "float32 softmax over 149 keys, another summation order"
    why_b = "float32 backward sums over 149 keys, another summation order"
    for masked in (False, True):
        q, k, v, _, g = flash_inputs(gen, 1, h, t, d, rows, False)
        bias = rel_pos_bias(gen, q, masked)
        got, want = fa.flash_fwd(q, k, v, bias, h), fa.flash_fwd_plain(q, k, v, bias, h)
        for name, x, y in (("o", got[0], want[0]), ("lse", got[1], want[1])):
            errs["flash_fwd_bias"] = max(errs["flash_fwd_bias"], compare(
                f"flash_fwd_bias {name} BH={h} T={t} masked={masked}", x, y, 2e-5, 2e-4,
                why_f))
        o, lse = want
        dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, h)
        dq_p, dd_p, dbias_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
        n = g.shape[0]
        errs["flash_dq_dbias"] = max(
            errs["flash_dq_dbias"],
            compare(f"flash_dq_dbias dq N={n} masked={masked}", dq, dq_p, 5e-5, 5e-4, why_b),
            compare(f"flash_dq_dbias dd masked={masked}", dd, dd_p, 5e-5, 5e-4, why_b),
            compare(f"flash_dq_dbias dbias [{n}, {t}, {t}] masked={masked}", dbias, dbias_p,
                    5e-5, 5e-4, why_b))
        if masked:
            check(bool((dbias[..., t - 29:] == 0).all()), "dbias: masked keys not 0")
        del dq, dd, dbias, dq_p, dbias_p
        dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
        errs["flash_dkv_bias"] = max(
            errs["flash_dkv_bias"],
            compare(f"flash_dkv_bias dk N={n} masked={masked}", dk, dk_p, 5e-5, 5e-4, why_b),
            compare(f"flash_dkv_bias dv N={n} masked={masked}", dv, dv_p, 5e-5, 5e-4, why_b))
        del q, k, v, g, bias, dk, dv, dk_p, dv_p
    for key, err in check_bwd_shapes(gen, h, full=True).items():
        errs[key] = max(errs[key], err)
    return errs, bwd_float64_check(gen, h, d, t, rows, full=True)


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
    log(f"pipeline {label}: {len(results)} samples x {NSAMPLES} draws in {wall:.2f} s; "
        f"launches {json.dumps(launches)}")
    t_out = cfg.model.frames_for_samples(N_SAMPLES)
    check(len(results) == len(test_set), "pipeline: missing samples")
    for r, sample in zip(results, test_set):
        phi = r["shap_values"]
        check(phi.shape == (N_SAMPLES, t_out), f"phi shape {phi.shape}")
        check(bool(np.isfinite(phi).all()), "phi not finite")
        check(float(np.abs(phi).max()) > 0, "phi all zero")
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


def archive_with_kernels(path: str, out: str) -> str:
    """A copy of the archive ``path`` whose embedded config selects the
    kernel impls, written to ``out`` by the port's save_params."""
    cfg = dataclasses.replace(load_config(path), attention_impl="pallas", conv_impl="pallas")
    save_params(out, load_params(path, device="cpu"), cfg)
    return out


def cli_run(label: str, archive: str, data_dir: str, args, arch="wav2vec2"):
    """run-shap then sweep on the card; each command's kernels must launch:
    the expected-gradients kernels of the path from run-shap, its flash
    forward (and nothing else) from sweep. Returns the sweep's records and
    its summary line."""
    model = ["--params", archive, "--arch", arch]
    kernels = CONFORMER_KERNELS if arch == "w2v2-conformer" else BASE_KERNELS
    cfg = load_config(archive)
    if not k1.eligible(cfg.conv_dim[0], cfg.conv_dim[1], cfg.conv_stride[1], 1, 0):
        kernels = kernels[1:]  # no conv layer K1 takes (narrow conv channels)
    (run,), run_launches, run_wall = run_cli(label, ["run-shap", *model, "--data-dir", data_dir,
                                                     *args])
    for name in kernels:
        check(run_launches.get(name, 0) > 0, f"cli {label}: run-shap did not launch {name}")
    lines, sweep_launches, sweep_wall = run_cli(label, ["sweep", *model, "--data-dir", data_dir])
    *records, summary = lines
    fwd = "flash_fwd_bias" if arch == "w2v2-conformer" else "flash_fwd"
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
    archive, and the trained conformer archive."""
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
    cli_run("conformer", conformer, f"{data_dir}/cli_conformer", [
        "--num-samples", "1", "--snrs", "5", "--min-length", str(N_SAMPLES),
        "--max-length", str(N_SAMPLES), "--nsamples", "2"], arch="w2v2-conformer")


PROFILE_GROUPS = (
    ("port kernels", ("dgrad_kernel", "flash_fwd_kernel", "flash_dq_mma_kernel",
                      "flash_dkv_mma_kernel")),
    ("convolution (cuDNN)", ("cudnn", "convolve", "winograd", "fft", "depthwise")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "cublas")),
)


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_draws(f, x, bg, ec: ExplainerConfig, n: int = 2) -> None:
    """Device time of ``n`` more draws by kernel group under torch.profiler
    (kept apart from the wall per draw above, which runs unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    draws = sample_draws(torch.Generator().manual_seed(6), n, ec.num_background)
    ec = dataclasses.replace(ec, nsamples=n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        expected_phi(f, x, bg, config=ec, draws=draws)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # device kernels only: a CPU op's entry repeats its kernels' time
    rows = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        log("profile: the profiler recorded no device time; breakdown not measured")
        return
    busy = sum(r[0] for r in rows)
    log(f"profile: {n} draws, wall {wall_ms:.1f} ms per draw with the profiler on; "
        f"device busy {busy:.1f} ms per draw ({100 * busy / wall_ms:.1f}% of wall)")
    groups: dict = {}
    for ms, _, key in rows:
        groups[_profile_group(key)] = groups.get(_profile_group(key), 0.0) + ms
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"profile group {g}: {ms:.2f} ms per draw ({100 * ms / busy:.1f}% of busy)")
    # the 12 longest, and every port kernel
    for i, (ms, count, key) in enumerate(rows):
        if i < 12 or _profile_group(key) == "port kernels":
            log(f"profile kernel {ms:9.3f} ms/draw {count:6.1f} calls/draw  {key[:100]}")


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

    # K2: per draw, one launch per encoder layer at B*H = 12
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
    out["flash_fwd"] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                            bound_by=b_by, library_ms=layers * lms, device_ms=layers * dms)

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

    time_slice("base", cfg, params, test_set, gen, out)
    return out


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
    run), launches per draw and peak device memory; then the profile."""
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
    profile_draws(f, x, bg, ec)


def phase_timing_conformer(cfg: PipelineConfig, params, test_set, k1_row):
    """K2f, K3b and K4f at the conformer slice's shapes, and the conformer
    slice per draw. K1's shapes here are the base path's (the same seven
    512-channel conv layers), so its row ``k1_row`` is timed once, there."""
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
        out[name] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                         bound_by=b_by, library_ms=layers * lms,
                         device_ms=None if dms is None else layers * dms)
    pair = out["flash_dq_dbias"]["ms"] + out["flash_dkv_bias"]["ms"]
    log(f"timing K3b + K4f per draw: {pair:.4f} ms ({layers} launches each) against the SDPA "
        f"backward (dq+dk+dv+d(mask), same inputs) per draw {layers * lib_bwd:.4f} ms "
        f"(ratio {pair / (layers * lib_bwd):.3f}); SDPA forward+backward per draw "
        f"{layers * lib_fwd_bwd:.4f} ms")
    del q, k, v, g, bias, o, lse, dd
    time_slice("conformer", cfg, params, test_set, gen, {**out, "conv_dgrad": k1_row})
    return out


def kernel_rows(out, errs, extra, launches):
    """The JSON line's entries: one per kernel, base path's first; ``extra``
    adds fields to a kernel's entry."""
    return [{
        "name": name, "route": "cuda", "source": ROUTES[name][0],
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
    smi = phase_build()
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

        cfg = PipelineConfig(model=model, explainer=explainer, seed=SEED,
                             data_dir=f"{data_dir}/base")
        params = init_wav2vec2_params(SEED, model, device="cuda")
        base_archive = f"{data_dir}/base_pallas.npz"
        save_params(base_archive, params, model)
        launches = phase_pipeline("base", cfg, params, test_set, BASE_KERNELS)
        phase_reference(cfg, params, test_set)
        out = phase_timing(cfg, params, test_set)
        del params

        ccfg = PipelineConfig(model=conformer, explainer=explainer, seed=SEED,
                              data_dir=f"{data_dir}/conformer")
        cparams = init_w2v2_conformer_params(SEED, conformer, device="cuda")
        claunches = phase_pipeline("conformer", ccfg, cparams, test_set, CONFORMER_KERNELS)
        phase_reference_conformer(ccfg, cparams, test_set, data_dir)
        cout = phase_timing_conformer(ccfg, cparams, test_set, out["conv_dgrad"])
        del cparams
        phase_cli(base_archive, data_dir)
        kernels = (kernel_rows(out, errs, extra, launches)
                   + kernel_rows(cout, errs, extra, claunches))
    log(smi)  # again beside the numbers, for a reader of the output's tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
