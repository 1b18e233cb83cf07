"""K1: the input gradient (dgrad) of a valid strided conv1d.

Replaces the Pallas TPU kernel ``asr_shap/kernels/conv_dgrad.py``
(``_dgrad_kernel``, launched by ``_dgrad_call``) with the CUDA kernel in
``csrc/conv_dgrad.cu``. It computes, for channels-last tensors and a kernel
``W [K, C_in, C_out]``, the polyphase sum

    xbar[b, v*s + r, :] = sum_d ybar[b, v - d, :] @ W[d*s + r].T

over the taps d with ``d*s + r < K`` and ``0 <= v - d < T_out``; rows with
no valid tap are zero. On Wav2Vec2's feature encoder (C = 512,
(K, s) in {(3, 2), (2, 2)}) with the explainer's T_out cotangent rows folded
into the batch it is a GEMM per phase r of 2*B*T_out*K*C_in*C_out operations
in all over a few bytes per operation, so operations bound it. The kernel
runs them on the tensor cores in 3xTF32: each operand is split into
``hi, lo = tf32_split(x)`` and the sum takes lo*hi + hi*lo, then hi*hi.
Each 8-wide step's products start from a zero partial sum that a float32
add then takes into the running sum, since the tensor cores round their
sums toward zero; so the result keeps float32's accuracy
(``tests/test_torch_kernels.py`` holds an emulation of the split to
float64; ``chip_smoke.py`` holds the kernel to float64 on the card, beside
the float32 plain version). Its bound is then three TF32
products per float32 product at the card's 495 TFLOP/s TF32 rate, 13.2 ms
per draw of the base path, against 32.5 ms for float32 FMAs. Design:
``mma.sync`` m16n8k8 TF32 with the split in registers, one block per
(128 rows (b, v), 128 input channels, phase r), a 3-stage ring of
shared-memory tiles filled by ``cp.async``, whose zero fill supplies the
halo rows ``v - d`` outside the clip; the phase interleave is the store
address (see the source note).

bf16 ybar and W (the model's ``dtype="bfloat16"``) launch the bf16 kernel
of ``csrc/conv_dgrad_bf16.cu``, its own library: ``wgmma`` m64n128k16 bf16
products with float32 sums (a product of two bf16 values is exact in
float32) fed by TMA through a ring of shared-memory tiles, one persistent
block per SM taking 128 rows v of one clip, 128 input channels and both
phases of a stride-2 layer at once, and xbar rounded to bf16 once, as the
reference's float32 accumulator cast to ybar's dtype. Its bound is its
operations at the card's 989 TFLOP/s bf16 rate.

The forward of the eligible layers stays ``F.conv1d``, as the reference
leaves it to ``lax.conv``. ``ConvDgrad`` carries a ``vmap`` rule that folds
the explainer's vmapped cotangent rows into the kernel's batch dimension,
as the reference's ``custom_vmap`` does; ``Conv1d``'s folds the draws of
an explainer chunk into the forward's batch, so that the backward's rows
reach K1 through the first rule. A ctypes launch cannot see a batched
tensor, so the rules are what make the batched VJP possible. The kernels
index with 64-bit offsets: a chunk of 4 draws puts 596 rows through the
largest layer, an xbar of 2.9e9 elements.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from asr_shap_torch.kernels import _build


def eligible(c_in: int, c_out: int, stride: int, groups: int,
             padding: int) -> bool:
    """Shapes the kernel takes: ungrouped, unpadded, strided convs with
    channel counts divisible by 128 (the C_in = 1 first layer and the
    grouped, padded positional conv are not eligible)."""
    return (groups == 1 and padding == 0 and stride > 1
            and c_in % 128 == 0 and c_out % 128 == 0)


def conv1d_dgrad_plain(ybar: torch.Tensor, kernel: torch.Tensor, stride: int,
                       t_in: int) -> torch.Tensor:
    """Plain PyTorch version: one matmul per tap, scattered into the strided
    rows it feeds (no [B, T, K*C] unfold). It sums in float32 from the
    upcast inputs and rounds to ybar's dtype once at the end, as the
    reference kernel does."""
    acc = _build.accumulation_dtype(ybar.dtype)
    y, w = ybar.to(acc), kernel.to(acc)
    b, t_out, _ = ybar.shape
    k_taps, c_in, _ = kernel.shape
    xbar = y.new_zeros((b, t_in, c_in))
    span = stride * (t_out - 1) + 1
    for k in range(k_taps):
        xbar[:, k:k + span:stride] += y @ w[k].T
    return xbar.to(ybar.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the rounding the kernels apply to each operand of a
    tensor-core product, bit for bit that of ``cvt.rna.tf32.f32``
    (``(bits + 0x1000) & ~0x1FFF`` on the float32 bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32_round(x) and lo = tf32_round(x - hi): the
    kernels' 3xTF32 operands, whose products lo*hi + hi*lo + hi*hi stand for
    one float32 product (lo*lo is dropped)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _check(ybar: torch.Tensor, kernel: torch.Tensor, stride: int, t_in: int):
    if ybar.ndim != 3 or kernel.ndim != 3:
        raise ValueError("conv1d_dgrad: ybar [B, T_out, C_out] and kernel "
                         "[K, C_in, C_out] expected")
    k_taps, c_in, c_out = kernel.shape
    if ybar.shape[2] != c_out:
        raise ValueError(f"conv1d_dgrad: C_out mismatch {ybar.shape} vs {kernel.shape}")
    if (t_in - k_taps) // stride + 1 != ybar.shape[1]:
        raise ValueError(f"conv1d_dgrad: T_out={ybar.shape[1]} does not follow "
                         f"from T_in={t_in}, K={k_taps}, stride={stride}")
    if ybar.device != kernel.device:
        raise ValueError("conv1d_dgrad: ybar and kernel on different devices")


_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
# the library, entry point and launch counter of each dtype the kernels take
_ENTRIES = {torch.float32: ("conv_dgrad", "conv1d_dgrad_f32", "conv_dgrad"),
            torch.bfloat16: ("conv_dgrad_bf16", "conv1d_dgrad_bf16", "conv_dgrad_bf16")}


def conv1d_dgrad(ybar: torch.Tensor, kernel: torch.Tensor, stride: int,
                 t_in: int) -> torch.Tensor:
    """ybar [B, T_out, C_out], kernel [K, C_in, C_out] -> xbar [B, T_in, C_in]
    in ybar's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of its dtype (float32 or bf16, ybar and kernel alike) or raises."""
    _check(ybar, kernel, stride, t_in)
    if ybar.device.type == "cpu":
        return conv1d_dgrad_plain(ybar, kernel, stride, t_in)
    if ybar.device.type != "cuda":
        raise ValueError(f"conv1d_dgrad: unsupported device {ybar.device}")
    entry = _ENTRIES.get(ybar.dtype)
    if entry is None or kernel.dtype != ybar.dtype:
        raise NotImplementedError(f"conv1d_dgrad: the CUDA kernels take float32 or "
                                  f"bf16 ybar and kernel alike, got {ybar.dtype} and "
                                  f"{kernel.dtype}")
    k_taps, c_in, c_out = kernel.shape
    if not eligible(c_in, c_out, stride, 1, 0):
        raise ValueError(f"conv1d_dgrad: shape not eligible for the kernel "
                         f"(C_in={c_in}, C_out={c_out}, stride={stride})")
    if not (ybar.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("conv1d_dgrad: contiguous tensors expected")
    if ybar.data_ptr() % 16 or kernel.data_ptr() % 16:
        raise ValueError("conv1d_dgrad: 16-byte aligned tensors expected")
    b, t_out, _ = ybar.shape
    out = torch.empty((b, t_in, c_in), device=ybar.device, dtype=ybar.dtype)
    if out.numel() == 0:
        return out
    if t_out == 0:  # no tap reaches any row
        return out.zero_()
    lib, fn_name, counter = entry
    fn = _build.c_function(lib, fn_name, _ARGTYPES)
    rc = fn(ybar.data_ptr(), kernel.data_ptr(), out.data_ptr(), b, t_out, t_in,
            c_out, c_in, k_taps, stride, _build.stream_of(ybar))
    if rc != 0:
        raise RuntimeError(f"conv1d_dgrad: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES[counter] += 1
    return out


def conv1d_forward(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                   padding: int = 0, groups: int = 1) -> torch.Tensor:
    """F.conv1d in the reference layouts: x [B, T, C_in], kernel
    [K, C_in // groups, C_out] -> [B, T', C_out]."""
    return F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0), stride=stride,
                    padding=padding, groups=groups).transpose(1, 2)


def _conv1d_wgrad(x: torch.Tensor, ybar: torch.Tensor, stride: int,
                  k_taps: int) -> torch.Tensor:
    """Weight gradient, one einsum per tap (the explainer never asks for it:
    its weights do not require grad)."""
    t_out = ybar.shape[1]
    span = stride * (t_out - 1) + 1
    return torch.stack([
        torch.einsum("bti,bto->io", x[:, k:k + span:stride], ybar)
        for k in range(k_taps)
    ])


class ConvDgrad(torch.autograd.Function):
    """The dgrad as a Function of its own, so that vmap reaches the kernel
    through the ``vmap`` rule below."""

    @staticmethod
    def forward(ybar, kernel, stride, t_in):
        return conv1d_dgrad(_build.kernel_input(ybar), _build.kernel_input(kernel),
                            stride, t_in)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("conv dgrad has no second derivative here")

    @staticmethod
    def vmap(info, in_dims, ybar, kernel, stride, t_in):
        if in_dims[1] is not None:
            raise NotImplementedError("conv dgrad: batched kernels under vmap")
        ybar = ybar.movedim(in_dims[0], 0)
        n = ybar.shape[0]
        flat = ybar.reshape((-1,) + ybar.shape[2:])
        out = ConvDgrad.apply(flat, kernel, stride, t_in)
        return out.reshape((n, -1) + out.shape[1:]), 0


class Conv1d(torch.autograd.Function):
    """Valid strided conv1d: F.conv1d forward, K1 as the input gradient."""

    @staticmethod
    def forward(x, kernel, stride):
        return conv1d_forward(x, kernel, stride)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, kernel, stride = inputs
        ctx.stride = stride
        ctx.t_in = x.shape[1]
        ctx.save_for_backward(x, kernel)

    @staticmethod
    def backward(ctx, ybar):
        x, kernel = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ConvDgrad.apply(ybar, kernel, ctx.stride, ctx.t_in)
        if ctx.needs_input_grad[1]:
            dw = _conv1d_wgrad(x, ybar, ctx.stride, kernel.shape[0])
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, kernel, stride):
        """Fold a vmapped x (the draws of an explainer chunk) into B: one
        forward, and autograd's node on the folded tensors, so that the
        backward's cotangent rows reach K1 through ``ConvDgrad``'s rule."""
        if in_dims[1] is not None:
            raise NotImplementedError("conv1d: batched kernels under vmap")
        if in_dims[0] is None:
            return Conv1d.apply(x, kernel, stride), None
        x = x.movedim(in_dims[0], 0)
        y = Conv1d.apply(x.reshape((-1,) + x.shape[2:]), kernel, stride)
        return y.reshape(x.shape[:2] + y.shape[1:]), 0


def conv1d(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> torch.Tensor:
    """x [B, T, C_in], kernel [K, C_in, C_out] -> [B, T_out, C_out], with
    K1 as the input gradient."""
    return Conv1d.apply(x, kernel, stride)
