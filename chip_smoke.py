#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (asr_shap_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. the card's name and power limit (nvidia-smi); build every kernel from
   asr_shap_torch/csrc with nvcc, one process per source, all at once;
2. hold each kernel against its plain PyTorch version on the card, float32,
   at the main path's shapes, with the tolerance stated beside it;
3. drive the main path: run_shap_pipeline at full Wav2Vec2-base width
   (random weights from a seed) on a 48,000-sample clip and its 5 dB
   white-noise mix, 4 expected-gradients draws each, with the launch counts
   set to 0 just before and read just after; check phi, the store and the
   counts, and score each sample (transcript, confidence, eta_raw, WER);
4. check the result against a reference: phi of one full-width draw
   through the kernels against the same draw through plain PyTorch, and a
   narrow model on the card against the CPU;
5. time each kernel with CUDA events beside its bound, its plain version and
   one library call; time the slice per draw, then profile two more draws
   (torch.profiler: device busy share, time by kernel group). A kernel's times in the
   JSON line are per draw of the main path: the sum over the launches one
   draw makes (K1 once per eligible conv layer, K2-K4 once per encoder
   layer); its "launches" is the count from the pipeline run of phase 3.

Prints one JSON line of per-kernel numbers, then as the last line
{"ok": true, "device": {...}}. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    ExplainerConfig,
    MetricConfig,
    PipelineConfig,
    Wav2Vec2Config,
)
from asr_shap_torch.core.device import highest_precision
from asr_shap_torch.core.store import AttributionStore, key_for
from asr_shap_torch.explain.expected_gradients import expected_phi, sample_draws
from asr_shap_torch.kernels import LAUNCHES, build_all, reset_launches
from asr_shap_torch.kernels import _build
from asr_shap_torch.kernels import conv_dgrad as k1
from asr_shap_torch.kernels import flash_attention as fa
from asr_shap_torch.metrics.eta_raw import eta_raw
from asr_shap_torch.metrics.wer import wer
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params
from asr_shap_torch.pipeline.run_shap import run_shap_pipeline

N_SAMPLES = 48_000
NSAMPLES = 4
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


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


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            if "Used" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    return smi


def phase_checks(cfg: Wav2Vec2Config):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {}
    rows = cfg.frames_for_samples(N_SAMPLES)  # 149 cotangent rows per draw
    why = "float32 sums of up to 1,536 products, another summation order"
    k_err = 0.0
    shapes = k1_main_shapes(cfg, rows)
    cases = [(rows, k, s, ci, co, ti, to) for (k, s, ci, co, ti, to) in
             (shapes[0], shapes[-1])]
    cases += [(5, 3, 2, 512, 512, 1000, 499),    # ragged rows, a trailing zero row
              (4, 5, 3, 256, 128, 802, 266)]     # non-dividing K/s, C_in != C_out
    for b, k, s, ci, co, ti, to in cases:
        ybar, w = k1_inputs(gen, b, k, ci, co, to)
        got = k1.conv1d_dgrad(ybar, w, s, ti)
        want = k1.conv1d_dgrad_plain(ybar, w, s, ti)
        k_err = max(k_err, compare(f"conv_dgrad B={b} K={k} s={s} C={ci}x{co} "
                                   f"T_out={to}", got, want, 5e-4, 1e-4, why))
        del ybar, w, got, want
    errs["conv_dgrad"] = k_err

    h, d, t = cfg.num_attention_heads, cfg.head_dim, rows
    for key in ("flash_fwd", "flash_dq", "flash_dkv"):
        errs[key] = 0.0
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
        dq, dd = fa.flash_dq(q, k, v, o, lse, g, bias, h)
        dq_p, dd_p = fa.flash_dq_plain(q, k, v, o, lse, g, bias, h)
        why_b = "float32 backward sums over 149 keys, another summation order"
        errs["flash_dq"] = max(errs["flash_dq"],
                               compare(f"flash_dq N={g.shape[0]} mask={masked}", dq, dq_p, 5e-5, 5e-4, why_b),
                               compare(f"flash_dq dd mask={masked}", dd, dd_p, 5e-5, 5e-4, why_b))
        dk, dv = fa.flash_dkv(q, k, v, lse, g, dd_p, bias, h)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, lse, g, dd_p, bias, h)
        errs["flash_dkv"] = max(errs["flash_dkv"],
                                compare(f"flash_dkv dk N={g.shape[0]} mask={masked}", dk, dk_p, 5e-5, 5e-4, why_b),
                                compare(f"flash_dkv dv N={g.shape[0]} mask={masked}", dv, dv_p, 5e-5, 5e-4, why_b))
    return errs


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


def phase_pipeline(cfg: PipelineConfig, params, test_set, data_dir):
    store = AttributionStore(data_dir)
    reset_launches()
    t0 = time.perf_counter()
    results = run_shap_pipeline(params, cfg, test_set, store=store, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    log(f"pipeline: {len(results)} samples x {NSAMPLES} draws in {wall:.2f} s; "
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
        log(f"sample {r['index']} {r['type']} snr={r['snr']}: "
            f"transcript={r['transcription']!r} confidence={r['confidence']:.6f} "
            f"eta_raw_strict={eta:.6f} wer={wer(sample['text'], r['transcription']):.6f} "
            f"wall_s={r['wall_s']:.3f} phi_absmax={float(np.abs(phi).max()):.6e}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches


def phase_reference(cfg: PipelineConfig, params, test_set):
    """phi of one draw through the kernels vs through plain PyTorch on the
    card at full width, and a narrow model on the card vs the CPU."""
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
    compare("phi full width, kernels vs plain PyTorch (one draw)", phi_k, phi_p,
            2e-3 * scale, 0.0, "2e-3 of max|phi|: float32 through 12 layers, "
            "another summation order in every product")

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


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


PROFILE_GROUPS = (
    ("port kernels", ("dgrad_kernel", "flash_fwd_kernel", "flash_dq_kernel",
                      "flash_dkv_kernel")),
    ("convolution (cuDNN)", ("cudnn", "convolve", "winograd", "fft")),
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
    for ms, count, key in rows[:12]:
        log(f"profile kernel {ms:9.3f} ms/draw {count:6.1f} calls/draw  {key[:100]}")


def phase_timing(cfg: PipelineConfig, params, test_set, errs, launches):
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
        b_ms, b_by = bound(fl, nb)
        log(f"timing conv_dgrad B={rows} K={k} s={s} T_out={to}: ms={ms:.4f} "
            f"plain_ms={pms:.4f} library_ms={lms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"TFLOP/s={fl / ms / 1e9:.2f}")
        for key, val in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("flops", fl), ("bytes", nb)):
            tot[key] += val
        del ybar, w, x_nct, y_nct, w_oik
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    out["conv_dgrad"] = dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=b_ms,
                             bound_by=b_by, library_ms=tot["library_ms"])

    # K2: per draw, one launch per encoder layer at B*H = 12
    q, k, v, bias, _ = flash_inputs(gen, 1, h, t, d, 1, False)
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, None, h), 50)
    pms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, None, h), 50)
    q4, k4, v4 = (x.reshape(1, h, t, d) for x in (q, k, v))
    lms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 50)
    bh = h
    fl = 4.0 * bh * t * t * d
    nb = 4.0 * (4 * bh * t * d + bh * t)
    b_ms, b_by = bound(fl, nb)
    log(f"timing flash_fwd BH={bh} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
        f"library_ms={lms:.4f} bound_ms={b_ms:.5f} ({b_by})")
    out["flash_fwd"] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                            bound_by=b_by, library_ms=layers * lms)

    # K3, K4: per draw, one launch each per encoder layer, 149 rows folded
    q, k, v, bias, g = flash_inputs(gen, 1, h, t, d, rows, False)
    o, lse = fa.flash_fwd(q, k, v, None, h)
    _, dd = fa.flash_dq(q, k, v, o, lse, g, None, h)
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
        b_ms, b_by = bound(fl, nb)
        log(f"timing {name} N={n} T={t}: ms={ms:.4f} plain_ms={pms:.4f} "
            f"library_ms(SDPA backward, dq+dk+dv)={lib_bwd:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}) TFLOP/s={fl / ms / 1e9:.2f}")
        out[name] = dict(ms=layers * ms, plain_ms=layers * pms, bound_ms=layers * b_ms,
                         bound_by=b_by, library_ms=layers * lib_bwd)
    del qe, ke, ve, oe

    # the slice per draw: sample 0's explainer, 3 draws after the pipeline run
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
    per_draw_launches = {kname: c / 3 for kname, c in LAUNCHES.items()}
    log(f"slice: wall per draw {per_draw * 1e3:.1f} ms (3 draws, {N_SAMPLES} samples, "
        f"T_out={rows}); launches per draw {json.dumps(per_draw_launches)}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernel_sum = sum(v["ms"] for v in out.values())
    log(f"slice: the four kernels' time per draw {kernel_sum:.1f} ms "
        f"({100 * kernel_sum / (per_draw * 1e3):.1f}% of the draw's wall)")
    profile_draws(f, x, bg, ec)

    routes = {
        "conv_dgrad": ("asr_shap_torch/csrc/conv_dgrad.cu", "asr_shap/kernels/conv_dgrad.py:150"),
        "flash_fwd": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:118"),
        "flash_dq": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:247"),
        "flash_dkv": ("asr_shap_torch/csrc/flash_attention.cu", "asr_shap/kernels/flash_attention.py:282"),
    }
    kernels = []
    for name, (src, replaces) in routes.items():
        row = out[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a "
              "CUDA device", file=sys.stderr)
        return 1
    phase_build()
    model = Wav2Vec2Config(attention_impl="pallas", conv_impl="pallas")
    # TF32 off for matmuls and cuDNN convs: kernels, plain versions and
    # yardsticks all run in float32
    with highest_precision(), tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        errs = phase_checks(model)
        cfg = PipelineConfig(
            model=model,
            explainer=ExplainerConfig(nsamples=NSAMPLES, method="grad", aggregation="max",
                                      draw_chunk=1, output_chunk=0, num_background=5),
            data_dir=data_dir, seed=SEED)
        params = init_wav2vec2_params(SEED, model, device="cuda")
        test_set = make_test_set()
        launches = phase_pipeline(cfg, params, test_set, data_dir)
        phase_reference(cfg, params, test_set)
        kernels = phase_timing(cfg, params, test_set, errs, launches)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
