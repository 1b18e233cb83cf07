"""K2-K4: flash attention forward, dq backward and dk/dv backward.

Replace the Pallas TPU kernels of ``asr_shap/kernels/flash_attention.py``:
K2 ``_fwd_kernel`` (launched by ``_fwd``), K3 ``_dq_kernel`` and K4
``_dkv_kernel`` (both launched by ``_bwd``), with the CUDA kernels in
``csrc/flash_attention.cu``. Scores are ``(q * D^-1/2) . k + bias``; the
bias is absent or a ``[B, 1, 1, T]`` additive key mask, which gets a zero
cotangent, as on the reference's kernel path. The reference's
differentiable ``[B, H, T, T]`` score bias and its d(bias) output (K3b) are
not ported yet and raise.

On the main path the backward dominates: the explainer folds its T_out
vmapped cotangent rows into the batch, so K3 and K4 see about 1,800
(row, head) pairs of [149, 64] float32 per layer and per draw. They do
14*T*T*D operations per pair on O(T*D) bytes, so the card's float32 FMA
rate bounds them. Each kernel keeps its scores and probabilities in
registers and shared memory, never in device memory (see the source note).
The forward residuals (q, k, v, o, lse) are stored once; cotangent row n
reads residual row ``n % (B*H)``, so folding the rows in copies nothing.

``FlashBackward`` carries the ``vmap`` rule that folds the vmapped axis of
the cotangent into the kernels' leading dimension; a ctypes launch cannot
see a batched tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from asr_shap_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


# ------------------------------------------------------------ plain versions

def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [BH, T, D]; bias None or [B, T] -> (o [BH, T, D], lse [BH, T])."""
    scale = q.shape[-1] ** -0.5
    s = (q * scale) @ k.transpose(1, 2)
    if bias is not None:
        s = s + bias.repeat_interleave(heads, dim=0)[:, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v) / l
    return o, (m + torch.log(l))[..., 0]


def _fold(g: torch.Tensor, bh: int) -> torch.Tensor:
    """[N, T, D] cotangents -> [N // BH, BH, T, D]."""
    return g.reshape(-1, bh, *g.shape[1:])


def _scores(q, k, bias, heads):
    s = (q * q.shape[-1] ** -0.5) @ k.transpose(1, 2)      # [BH, T, T]
    if bias is not None:
        s = s + bias.repeat_interleave(heads, dim=0)[:, None, :]
    return s


def flash_dq_plain(q, k, v, o, lse, g, bias, heads
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals [BH, T, D] (lse [BH, T]), g [N, T, D] with N a multiple of
    BH -> (dq [N, T, D], dd = rowsum(g * o) [N, T])."""
    bh = q.shape[0]
    g4 = _fold(g, bh)
    p = torch.exp(_scores(q, k, bias, heads) - lse[..., None])
    dd = (g4 * o).sum(dim=-1)                                # [V, BH, T]
    ds = p * (g4 @ v.transpose(1, 2) - dd[..., None])
    dq = q.shape[-1] ** -0.5 * (ds @ k)
    return dq.reshape(g.shape), dd.reshape(g.shape[:2])


def flash_dkv_plain(q, k, v, lse, g, dd, bias, heads
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dk, dv), each [N, T, D]; dd as returned by ``flash_dq_plain``."""
    bh = q.shape[0]
    g4 = _fold(g, bh)
    p = torch.exp(_scores(q, k, bias, heads) - lse[..., None])   # [BH, Tq, Tk]
    dv = p.transpose(1, 2) @ g4
    ds = p * (g4 @ v.transpose(1, 2) - dd.reshape(g4.shape[:3])[..., None])
    dk = ds.transpose(-1, -2) @ (q * q.shape[-1] ** -0.5)
    return dk.reshape(g.shape), dv.reshape(g.shape)


# ------------------------------------------------------------ kernel wrappers

def _check(q, k, v, bias, heads, o=None, lse=None, g=None, dd=None) -> bool:
    """Validate the inputs of one kernel wrapper; True for the CPU (plain
    version), False for CUDA (kernel). Raises on anything the kernels do
    not take."""
    if q.ndim != 3:
        raise ValueError(f"flash attention: q [BH, T, D] expected, got {tuple(q.shape)}")
    bh, t, d = q.shape
    n = bh if g is None else g.shape[0]
    if bh % heads or n % bh:
        raise ValueError(f"flash attention: BH={bh}, N={n} and H={heads} do not divide")
    expected = {"k": (k, (bh, t, d)), "v": (v, (bh, t, d)), "o": (o, (bh, t, d)),
                "lse": (lse, (bh, t)), "g": (g, (n, t, d)), "dd": (dd, (n, t)),
                "bias": (bias, (bh // heads, t))}
    tensors = [q]
    for name, (x, shape) in expected.items():
        if x is None:
            continue
        if tuple(x.shape) != shape:
            raise ValueError(f"flash attention: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != q.device:
            raise ValueError("flash attention: tensors on different devices")
        tensors.append(x)
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    for x in tensors:
        if x.dtype != torch.float32:
            raise NotImplementedError("flash attention: the CUDA kernels take "
                                      "float32 only (bf16 is not ported yet)")
        if not x.is_contiguous():
            raise ValueError("flash attention: contiguous tensors expected")
    if d not in (32, 64):
        raise ValueError(f"flash attention: head dim {d} not in (32, 64)")
    return False


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fn(name: str, nargs_ptr: int, nargs_int: int):
    return _build.c_function("flash_attention", name,
                             [_P] * nargs_ptr + [_I] * nargs_int + [ctypes.c_float, _P])


def flash_fwd(q, k, v, bias, heads):
    """K2. q, k, v [BH, T, D]; bias None or [B, T] -> (o, lse [BH, T])."""
    if _check(q, k, v, bias, heads):
        return flash_fwd_plain(q, k, v, bias, heads)
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device=q.device, dtype=torch.float32)
    rc = _fn("flash_fwd_f32", 6, 4)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(bias), _ptr(o), _ptr(lse),
        bh, t, d, heads, d ** -0.5, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_dq(q, k, v, o, lse, g, bias, heads):
    """K3. g [N, T, D], N a multiple of BH -> (dq [N, T, D], dd [N, T])."""
    if _check(q, k, v, bias, heads, o=o, lse=lse, g=g):
        return flash_dq_plain(q, k, v, o, lse, g, bias, heads)
    bh, t, d = q.shape
    n = g.shape[0]
    dq = torch.empty_like(g)
    dd = torch.empty((n, t), device=g.device, dtype=torch.float32)
    rc = _fn("flash_dq_f32", 9, 5)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(g), _ptr(bias),
        _ptr(dq), _ptr(dd), n, bh, t, d, heads, d ** -0.5, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_dq: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES["flash_dq"] += 1
    return dq, dd


def flash_dkv(q, k, v, lse, g, dd, bias, heads):
    """K4. dd as returned by K3 -> (dk, dv), each [N, T, D]."""
    if _check(q, k, v, bias, heads, lse=lse, g=g, dd=dd):
        return flash_dkv_plain(q, k, v, lse, g, dd, bias, heads)
    bh, t, d = q.shape
    n = g.shape[0]
    dk = torch.empty_like(g)
    dv = torch.empty_like(g)
    rc = _fn("flash_dkv_f32", 9, 5)(
        _ptr(q), _ptr(k), _ptr(v), _ptr(lse), _ptr(g), _ptr(dd), _ptr(bias),
        _ptr(dk), _ptr(dv), n, bh, t, d, heads, d ** -0.5, _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash_dkv: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES["flash_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------ autograd

def _mask_rows(bias: Optional[torch.Tensor], b: int, t: int):
    """[B, 1, 1, T] (or broadcastable) mask -> contiguous [B, T] float32."""
    if bias is None:
        return None
    if bias.ndim != 4 or bias.shape[1:3] != (1, 1):
        raise NotImplementedError(
            "flash attention: only [B, 1, 1, T] masks are ported; the "
            "differentiable [B, H, T, T] score bias (K3b) is not yet")
    return _build.kernel_input(bias[:, 0, 0, :].expand(b, t).to(torch.float32))


class FlashBackward(torch.autograd.Function):
    """K3 then K4. g may carry V cotangents per residual row: its leading
    dim is V*B while the residuals' is B."""

    @staticmethod
    def forward(q, k, v, o, lse, g, bias):
        b, h, t, d = q.shape
        res = [_build.kernel_input(x.reshape(b * h, t, d)) for x in (q, k, v, o)]
        lse3 = _build.kernel_input(lse.reshape(b * h, t))
        g3 = _build.kernel_input(g.reshape(-1, t, d))
        bias2 = _mask_rows(bias, b, t)
        dq, dd = flash_dq(*res, lse3, g3, bias2, h)
        dk, dv = flash_dkv(*res[:3], lse3, g3, dd, bias2, h)
        return tuple(x.reshape(g.shape) for x in (dq, dk, dv))

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash backward has no second derivative here")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, g, bias):
        if any(dim is not None for i, dim in enumerate(in_dims) if i != 5):
            raise NotImplementedError("flash backward: batched residuals under vmap")
        g = g.movedim(in_dims[5], 0)
        nv = g.shape[0]
        flat = g.reshape((-1,) + g.shape[2:])                  # [V*B, H, T, D]
        outs = FlashBackward.apply(q, k, v, o, lse, flat, bias)
        return tuple(x.reshape((nv,) + q.shape) for x in outs), (0, 0, 0)


class FlashAttention(torch.autograd.Function):
    """K2 forward; K3/K4 backward through ``FlashBackward``."""

    @staticmethod
    def forward(q, k, v, bias):
        b, h, t, d = q.shape
        q3, k3, v3 = (_build.kernel_input(x.reshape(b * h, t, d)) for x in (q, k, v))
        o3, lse = flash_fwd(q3, k3, v3, _mask_rows(bias, b, t), h)
        return o3.reshape(b, h, t, d), lse.reshape(b, h, t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, bias = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse, bias)

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, o, lse, bias = ctx.saved_tensors
        dq, dk, dv = FlashBackward.apply(q, k, v, o, lse, g, bias)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            dbias = torch.zeros_like(bias)  # masks are constants
        return dq, dk, dv, dbias


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over [B, H, T, D]; ``bias`` None or a [B, 1, 1, T] mask."""
    return FlashAttention.apply(q, k, v, bias)[0]
