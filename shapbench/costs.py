"""The yardstick's arithmetic: the card's peaks, the least time of a
function from its operations and bytes, the operations and bytes of the
port's kernels at given shapes, and the model FLOPs of a draw.

Peaks: one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 989
TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s of HBM. The port's float32 kernels run 3xTF32 (three TF32
products per float32 product), so a float32 product's peak here is 495 / 3
= 165 TFLOP/s: against 67, a 3xTF32 GEMM could read over 100%.

``k1_cost``, ``flash_costs``, ``bf16_flash_costs``, ``flash_cost`` and the
``bound*`` functions are copies of ``chip_smoke.py``'s (each input read
once, each output written once, the scores counted once per residual
row)."""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_3XTF32 = PEAK_TF32 / 3
POWER_LIMIT_W = 700.0  # the power limit the peaks assume


def product_peak(dtype: str) -> float:
    """The peak of a product in the cell's compute dtype: bf16's, or
    float32 at three TF32 products."""
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_3XTF32


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_bf16(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations (bf16)") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_3xtf32(flops: float, nbytes: float):
    t_ops, t_bytes = 3 * flops / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations (3xTF32)") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_bound(flops: float, nbytes: float, dtype: str):
    """(least ms, what bounds it) of a kernel on the cell's dtype."""
    return bound_bf16(flops, nbytes) if dtype == "bfloat16" else bound_3xtf32(flops, nbytes)


def k1_cost(b, k, s, c_in, c_out, t_in, t_out):
    """(operations, float32 bytes) of one conv dgrad: ybar and the kernel
    read, xbar written."""
    flops = 2.0 * b * t_out * k * c_in * c_out
    nbytes = 4.0 * (b * t_out * c_out + k * c_in * c_out + b * t_in * c_in)
    return flops, nbytes


def flash_costs(bh, n, t, d):
    """(operations, bytes) of one launch of each float32 flash kernel with a
    full bias."""
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


def bf16_flash_costs(bh, n, t, d):
    """(operations, bytes) of one launch of K2, K3 and K4 on bf16 inputs."""
    return {
        "flash_fwd_bf16": (4.0 * bh * t * t * d, 2.0 * 4 * bh * t * d + 4.0 * bh * t),
        "flash_dq_bf16": (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                          2.0 * (2 * n * t * d + 4 * bh * t * d) + 4.0 * (n * t + bh * t)),
        "flash_dkv_bf16": (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
                           2.0 * (3 * n * t * d + 3 * bh * t * d) + 4.0 * (n * t + bh * t)),
    }


def flash_cost(kind: str, bh: int, n: int, t: int, d: int, dtype: str, full: bool):
    """(operations, bytes) of one launch of the flash forward ("fwd"), dq
    ("dq") or dk/dv ("dkv") over bh residual rows and n cotangent rows of
    length t and width d: q, k, v, o, g, dq, dk, dv in the dtype; lse, dd,
    the full bias and d(bias) float32."""
    e = 2.0 if dtype == "bfloat16" else 4.0
    tt = 4.0 * bh * t * t if full else 0.0
    if kind == "fwd":
        return 4.0 * bh * t * t * d, e * 4 * bh * t * d + 4.0 * bh * t + tt
    if kind == "dq":
        return (4.0 * n * t * t * d + 2.0 * bh * t * t * d,
                e * (2 * n * t * d + 4 * bh * t * d) + 4.0 * (n * t + bh * t) + tt
                + (4.0 * n * t * t if full else 0.0))
    return (6.0 * n * t * t * d + 2.0 * bh * t * t * d,
            e * (3 * n * t * d + 3 * bh * t * d) + 4.0 * (n * t + bh * t) + tt)


def conv_layers(arch, n: int) -> List[Tuple[int, int, int, int, int, int]]:
    """(K, s, C_in, C_out, T_in, T_out) of each feature-encoder conv for a
    clip of n samples."""
    out, t, c_in = [], n, 1
    for c, k, s in zip(arch["conv_dim"], arch["conv_kernel"], arch["conv_stride"]):
        t_out = (t - k) // s + 1
        out.append((k, s, c_in, c, t, t_out))
        t, c_in = t_out, c
    return out


def conv_encoder_flops(arch, n: int) -> float:
    """FLOPs of the conv feature encoder's products for one clip."""
    return sum(2.0 * t_out * k * c_in * c_out for k, _, c_in, c_out, _, t_out
               in conv_layers(arch, n))


def dgrad_layers(arch, n: int):
    """The feature-encoder layers whose input gradient the conv dgrad kernel
    (K1) computes: ungrouped strided convs with 128-divisible channels."""
    return [l for l in conv_layers(arch, n)
            if l[1] > 1 and l[2] % 128 == 0 and l[3] % 128 == 0]


def backward_calls(workload) -> Iterator[Tuple[int, int]]:
    """(draws, cotangent rows) of each batched backward of one clip: each
    draw chunk of ``draw_chunk`` draws pushes its T_out rows through in
    slices of ``output_chunk`` (0: all at once)."""
    ex = workload["explainer"]
    chunk = max(1, ex["draw_chunk"])
    chunks = math.ceil(ex["nsamples"] / chunk)
    t_out = workload["t_out"]
    oc = ex["output_chunk"]
    step = oc if 0 < oc < t_out else t_out
    for _ in range(chunks):
        for s in range(0, t_out, step):
            yield chunk, min(step, t_out - s)


def draws_per_clip(workload) -> int:
    """``nsamples`` rounded up to a multiple of ``draw_chunk``."""
    ex = workload["explainer"]
    chunk = max(1, ex["draw_chunk"])
    return math.ceil(ex["nsamples"] / chunk) * chunk


def clip_plan(workload, arch) -> Dict[str, Tuple[float, float, float, int]]:
    """Per clip: {kernel family: (operations, bytes, least ms, launches)}
    of the conv dgrad ("conv_dgrad") and the flash dq and dk/dv launches
    ("flash_bwd"), from the cell's shapes."""
    dtype = workload["numerics"]["dtype"]
    n = workload["clips"]["samples"]
    t, heads = workload["t_out"], arch["num_attention_heads"]
    d = arch["hidden_size"] // heads
    full = arch.get("position_embeddings_type", "none") == "relative"
    layers = dgrad_layers(arch, n)
    plan = {"conv_dgrad": [0.0, 0.0, 0.0, 0], "flash_bwd": [0.0, 0.0, 0.0, 0]}
    for chunk, rows in backward_calls(workload):
        for k, s, ci, co, ti, to in layers:
            fl, nb = k1_cost(rows * chunk, k, s, ci, co, ti, to)
            nb = nb / 2 if dtype == "bfloat16" else nb
            _acc(plan["conv_dgrad"], fl, nb, dtype)
        for _ in range(arch["num_hidden_layers"]):
            for kind in ("dq", "dkv"):
                fl, nb = flash_cost(kind, chunk * heads, rows * chunk * heads, t, d, dtype, full)
                _acc(plan["flash_bwd"], fl, nb, dtype)
    return {k: tuple(v) for k, v in plan.items()}


def _acc(row, fl, nb, dtype):
    row[0] += fl
    row[1] += nb
    row[2] += kernel_bound(fl, nb, dtype)[0]
    row[3] += 1
