"""The input gradient of a linear, ``gx = g @ w.T``, for float32 operands on
the card: a 3xTF32 GEMM on Hopper's ``wgmma`` (``csrc/gemm_tf32x3.cu``).

It replaces no Pallas kernel: the reference leaves ``dot`` to XLA at
``Precision.HIGHEST``. With TF32 off ("highest"), cuBLAS runs float32
products on the CUDA cores, at 73% of their 67 TFLOP/s; the input gradients
of the linears (``ops/remat.py::dot``) are the largest device op of the
float32 explainer, since each draw backpropagates T_out cotangent rows
through every linear. The kernel runs them on the tensor cores in 3xTF32,
the precision the port's other float32 kernels hold "highest" to: each
operand split by ``conv_dgrad.tf32_split``, the sum lo*hi + hi*lo, then
hi*hi, each 32-wide step from a zero partial added to the running sum in
float32 (see the source note). Its bound is three TF32 products per
float32 product at the card's 495 TFLOP/s.

``gemm_nt(a, b)`` computes ``a @ b.T`` for a [M, K] and b [N, K], both
K-major as stored (b is the weight [in, out], so K = out and N = in). A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``GemmNT`` is the product as an ``autograd.Function`` whose ``vmap``
rule folds every vmapped dimension of ``a`` (the explainer's cotangent rows
and the draws of a chunk) into M as a view, so a backward call makes one
launch per product. ``takes`` is the route ``dot`` follows: the kernel for
float32 operands on the card under "highest" at an eligible shape;
everything else (bf16, "default", the CPU, the weight gradient) stays on
``torch.matmul``. The kernel keeps no split or transposed copy of a weight.
"""

from __future__ import annotations

import ctypes

import torch

from asr_shap_torch.core.device import precision_active
from asr_shap_torch.kernels import _build

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)


def eligible(n: int, k: int) -> bool:
    """Shapes the kernel takes: b [N, K] with rows of whole 16-byte units
    (TMA's strides) and N a multiple of 4 (the epilogue's pairs). TMA's zero
    fill masks the ragged tiles, so no multiple of the tile is needed."""
    return n > 0 and k > 0 and n % 4 == 0 and k % 4 == 0


def takes(g: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether ``g @ w.T`` (``w`` [in, out]) goes to the kernel: float32
    operands on the card, under "highest", at an eligible shape. bf16 and
    float16 stay on cuBLAS's tensor-core GEMM, "default" on cuBLAS's TF32,
    the CPU on its own matmul."""
    return (g.device.type == "cuda" and g.dtype == torch.float32
            and w.dtype == torch.float32 and w.ndim == 2
            and precision_active("highest") and eligible(w.shape[0], w.shape[1]))


def gemm_nt_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``a @ b.T``."""
    return a @ b.transpose(0, 1)


def gemm_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K], b [N, K] -> a @ b.T [M, N].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32, contiguous, 16-byte aligned, an eligible shape) or raises."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"gemm_nt: a [M, K] and b [N, K] expected, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("gemm_nt: a and b on different devices")
    if a.device.type == "cpu":
        return gemm_nt_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_nt: unsupported device {a.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise NotImplementedError(f"gemm_nt: the kernel takes float32 a and b, got {a.dtype} "
                                  f"and {b.dtype}")
    m, k = a.shape
    n = b.shape[0]
    if not eligible(n, k):
        raise ValueError(f"gemm_nt: shape not eligible for the kernel (N={n}, K={k})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm_nt: contiguous tensors expected")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("gemm_nt: 16-byte aligned tensors expected")
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    if m == 0:
        return out
    fn = _build.c_function("gemm_tf32x3", "gemm_tf32x3_nt", _ARGTYPES)
    rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, _build.stream_of(a))
    if rc != 0:
        raise RuntimeError(f"gemm_nt: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES["gemm_tf32x3"] += 1
    return out


class GemmNT(torch.autograd.Function):
    """``a @ b.T`` for a [..., K] and b [N, K] -> [..., N]: every leading
    dimension of ``a`` is M, folded as a view where ``a`` is row-major."""

    @staticmethod
    def forward(a, b):
        out = gemm_nt(_build.kernel_input(a.reshape(-1, a.shape[-1])),
                      _build.kernel_input(b))
        return out.view(*a.shape[:-1], b.shape[0])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("gemm_nt has no second derivative here")

    @staticmethod
    def vmap(info, in_dims, a, b):
        """A vmapped ``a`` keeps its vmapped dimension where it is, as one
        more leading dimension of M (moved first only if it is the last);
        one launch serves every vmapped row."""
        if in_dims[1] is not None:
            raise NotImplementedError("gemm_nt: batched weights under vmap")
        a, dim = leading_vmapped(a, in_dims[0])
        return GemmNT.apply(a, b), dim


def leading_vmapped(a: torch.Tensor, dim: int):
    """(``a``, ``dim``) for a product over the last dimension of ``a`` whose
    vmapped dimension ``dim`` becomes one more leading dimension: left where
    it is (no copy), or moved first where it is the last."""
    return (a.movedim(-1, 0), 0) if dim == a.ndim - 1 else (a, dim)
