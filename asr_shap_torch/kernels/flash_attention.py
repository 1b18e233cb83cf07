"""K2-K4: flash attention forward, dq backward and dk/dv backward.

Replace the Pallas TPU kernels of ``asr_shap/kernels/flash_attention.py``:
K2 ``_fwd_kernel`` (launched by ``_fwd``), K3 ``_dq_kernel`` and K4
``_dkv_kernel`` (both launched by ``_bwd``), with the CUDA kernels in
``csrc/flash_attention.cu``. Scores are ``(q * D^-1/2) . k + bias``. The
bias is absent; a ``[B, 1, 1, T]`` additive key mask, which gets a zero
cotangent, as on the reference's kernel path; or any other rank-4 bias,
broadcast to a full ``[B, H, T, T]`` score bias (the rel-pos scores of the
conformer families). The full bias runs its own variants: K2f forward, K3b
dq that also writes d(bias) = ds, and K4f dk/dv; its cotangent is summed
back to the bias's own shape.

On the main path the backward dominates: the explainer folds its T_out
vmapped cotangent rows into the batch, so K3 and K4 see about 1,800
(row, head) pairs of [149, 64] float32 per layer and per draw, 149 of them
on each residual row. They do 14*T*T*D operations per pair on O(T*D)
bytes, so operations bound them. K3 and K4, and their full-bias variants
K3b and K4f (the same templates), run every product on the tensor cores in
3xTF32 (the rounding of ``conv_dgrad.tf32_split``) and compute each
residual row's probabilities once for a run of groups of 8 of its
cotangent rows. Each kernel keeps its scores and probabilities in
registers and shared memory, never in device memory (see the source note);
K3b writes its d(bias) = ds [N, T, T] from the registers it forms ds in.
The forward is a few MFLOP per launch, so its time is latency: K2 holds the
head's whole key row in shared memory, runs a single-pass softmax and both
products on the tensor cores in 3xTF32 (the rounding of
``conv_dgrad.tf32_split``), 16 or 32 query rows per block and
the keys of each 16 rows split over eight warps, whose partial softmax
sums meet in shared memory; ``fwd_block_rows`` picks the rows per block.
The forward residuals (q, k, v, o, lse) are stored once; cotangent row n
reads residual row ``n % (B*H)``, so folding the rows in copies nothing.

A ctypes launch cannot see a batched tensor, so both Functions carry
``vmap`` rules that fold a vmapped axis into the kernels' leading
dimension. ``FlashAttention``'s folds the draws of an explainer chunk into
B (one K2 launch per layer for the chunk); ``FlashBackward``'s folds the
cotangent rows outside the residuals' B, and, where the residuals are
vmapped too (a layer recomputed by remat under the draws' vmap), the
draws into B with the rows outside them, so that row n reads residual
row ``n % (B*H)`` in every case.

bf16 q, k, v (the model's ``dtype="bfloat16"``) launch the bf16 entry
points, with either bias kind: o, dq, dk, dv in the inputs' dtype; lse,
dd, the mask, the full bias and d(bias) float32, as the reference kernels
take and write them. The bf16 forward (``csrc/flash_fwd_bf16.cu``) and
backward (``csrc/flash_bwd_bf16.cu``) keep their shared rows in bf16 and
run m16n8k16 bf16 products: one per step for two bf16 operands, two for a
float32 operand (p, ds) split by ``bf16_split``. The plain versions compute
in float32 from the upcast inputs and round each bf16 output once, as the
reference kernels do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from asr_shap_torch.kernels import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# each entry point's C signature (csrc/flash_attention.cu, flash_fwd_bf16.cu,
# flash_bwd_bf16.cu)
_ARGTYPES = {
    "flash_fwd_f32": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    "flash_fwd_bf16": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    "flash_dq_bf16": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    "flash_dkv_bf16": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    "flash_fwd_bias_f32": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    "flash_dq_f32": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    "flash_dq_dbias_f32": (_P,) * 10 + (_I,) * 5 + (_F, _P),
    "flash_dkv_f32": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    "flash_dkv_bias_f32": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    "flash_fwd_bias_bf16": (_P,) * 6 + (_I,) * 5 + (_F, _P),
    "flash_dq_dbias_bf16": (_P,) * 10 + (_I,) * 5 + (_F, _P),
    "flash_dkv_bias_bf16": (_P,) * 9 + (_I,) * 5 + (_F, _P),
}
# K2's query rows per block: 16 or 32 (the keys of each 16 rows are split
# over 8 warps, 4 in bf16). The fewest rows whose grid still fits one wave
# on the card's SMs was the fastest on the H100, in float32 (PERF.md) and
# in bf16 (utils/flash_fwd_ablation.py): 16 for BH = 12, T = 149; 32 for
# BH = 16 and for the sweep's BH = 96.
FWD_ROWS = (16, 32)
_sm_count: dict = {}
# the library of each entry point that is not in csrc/flash_attention.cu
_LIBRARY = {**dict.fromkeys(("flash_fwd_bf16", "flash_fwd_bias_bf16"), "flash_fwd_bf16"),
            **dict.fromkeys(("flash_dq_bf16", "flash_dkv_bf16", "flash_dq_dbias_bf16",
                             "flash_dkv_bias_bf16"), "flash_bwd_bf16")}


# ------------------------------------------------------------ plain versions
#
# The kernels' bias argument: None, a [B, T] key mask or a full [BH, T, T]
# score bias (told apart by rank). Each plain version computes in the
# accumulation dtype (float32 for bf16 or float32 inputs, float64 for
# float64) from the upcast inputs, and rounds its outputs to the inputs'
# dtype once: lse and dd stay in the accumulation dtype.

def _is_full(bias: Optional[torch.Tensor]) -> bool:
    return bias is not None and bias.ndim == 3


def _up(*xs):
    """The inputs in their accumulation dtype (``_build.accumulation_dtype``)."""
    return tuple(None if x is None else x.to(_build.accumulation_dtype(x.dtype)) for x in xs)


def _scores(q, k, bias, heads):
    s = (q * q.shape[-1] ** -0.5) @ k.transpose(1, 2)      # [BH, T, T]
    if _is_full(bias):
        s = s + bias
    elif bias is not None:
        s = s + bias.repeat_interleave(heads, dim=0)[:, None, :]
    return s


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor], heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v [BH, T, D]; bias None, [B, T] or [BH, T, T]
    -> (o [BH, T, D] in q's dtype, lse [BH, T])."""
    dtype = q.dtype
    q, k, v, bias = _up(q, k, v, bias)
    s = _scores(q, k, bias, heads)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v) / l
    return o.to(dtype), (m + torch.log(l))[..., 0]


def _fold(g: torch.Tensor, bh: int) -> torch.Tensor:
    """[N, T, D] cotangents -> [N // BH, BH, T, D]."""
    return g.reshape(-1, bh, *g.shape[1:])


def flash_dq_plain(q, k, v, o, lse, g, bias, heads):
    """Residuals [BH, T, D] (lse [BH, T]), g [N, T, D] with N a multiple of
    BH -> (dq [N, T, D], dd = rowsum(g * o) [N, T], dbias): dbias = ds
    [N, T, T] for a full bias, else None; dq in q's dtype."""
    dtype, shape = q.dtype, g.shape
    q, k, v, o, lse, g, bias = _up(q, k, v, o, lse, g, bias)
    bh = q.shape[0]
    g4 = _fold(g, bh)
    p = torch.exp(_scores(q, k, bias, heads) - lse[..., None])
    dd = (g4 * o).sum(dim=-1)                                # [V, BH, T]
    ds = p * (g4 @ v.transpose(1, 2) - dd[..., None])
    dq = q.shape[-1] ** -0.5 * (ds @ k)
    dbias = ds.reshape(g.shape[0], *ds.shape[2:]) if _is_full(bias) else None
    return dq.reshape(shape).to(dtype), dd.reshape(shape[:2]), dbias


def flash_dkv_plain(q, k, v, lse, g, dd, bias, heads
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dk, dv), each [N, T, D] in k's / v's dtype; dd as returned by
    ``flash_dq_plain``."""
    dtypes, shape = (k.dtype, v.dtype), g.shape
    q, k, v, lse, g, dd, bias = _up(q, k, v, lse, g, dd, bias)
    bh = q.shape[0]
    g4 = _fold(g, bh)
    p = torch.exp(_scores(q, k, bias, heads) - lse[..., None])   # [BH, Tq, Tk]
    dv = p.transpose(1, 2) @ g4
    ds = p * (g4 @ v.transpose(1, 2) - dd.reshape(g4.shape[:3])[..., None])
    dk = ds.transpose(-1, -2) @ (q * q.shape[-1] ** -0.5)
    return dk.reshape(shape).to(dtypes[0]), dv.reshape(shape).to(dtypes[1])


def bf16_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = x rounded to bf16 (to nearest, ties to even) and
    lo = x - hi rounded to bf16, both returned as float32: the two bf16
    terms by which the bf16 backward kernels take a float32 operand (p, ds)
    into a tensor-core product, lo.b + hi.b (16 mantissa bits of x)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------ kernel wrappers

# the dtypes the kernels take for q, k, v, o and g
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, bias, heads, o=None, lse=None, g=None, dd=None) -> bool:
    """Validate the inputs of one kernel wrapper; True for the CPU (plain
    version), False for CUDA (kernel). Raises on anything the kernels do
    not take: on CUDA, q, k, v, o and g must share one dtype, float32 or
    bf16, and lse, dd and the bias (mask or full) must be float32."""
    if q.ndim != 3:
        raise ValueError(f"flash attention: q [BH, T, D] expected, got {tuple(q.shape)}")
    bh, t, d = q.shape
    n = bh if g is None else g.shape[0]
    if bh % heads or n % bh:
        raise ValueError(f"flash attention: BH={bh}, N={n} and H={heads} do not divide")
    # is_cuda and get_device() are the cheap queries: this runs per launch
    cuda = q.is_cuda
    if not cuda and q.device.type != "cpu":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    dev = q.get_device()
    if cuda and q.dtype not in _DTYPES:
        raise NotImplementedError(f"flash attention: the CUDA kernels take float32 or "
                                  f"bf16, got {q.dtype}")
    for name, x, shape in (
            ("q", q, (bh, t, d)), ("k", k, (bh, t, d)), ("v", v, (bh, t, d)),
            ("o", o, (bh, t, d)), ("lse", lse, (bh, t)), ("g", g, (n, t, d)),
            ("dd", dd, (n, t)),
            ("bias", bias, (bh, t, t) if _is_full(bias) else (bh // heads, t))):
        if x is None:
            continue
        if x.shape != shape:
            raise ValueError(f"flash attention: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if (x.is_cuda != cuda or x.get_device() != dev) if cuda else x.device != q.device:
            raise ValueError("flash attention: tensors on different devices")
        want = torch.float32 if name in ("lse", "dd", "bias") else q.dtype
        if cuda and x.dtype != want:
            raise NotImplementedError(f"flash attention: {name} is {x.dtype}, the "
                                      f"CUDA kernels take {want} here")
        if cuda and not x.is_contiguous():
            raise ValueError("flash attention: contiguous tensors expected")
    if cuda and d not in (32, 64):
        raise ValueError(f"flash attention: head dim {d} not in (32, 64)")
    return not cuda


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _entry(kernel: str, full_kernel: Optional[str], q, bias) -> Tuple[str, str]:
    """(entry point, launch counter) of ``kernel``, or of its full-bias
    variant ``full_kernel`` for a full bias, for q's dtype."""
    name = full_kernel if _is_full(bias) else kernel
    if q.dtype == torch.bfloat16:
        return f"{name}_bf16", f"{name}_bf16"
    return f"{name}_f32", name


def _launch(name: str, counter: str, *args) -> None:
    """Call entry point ``name`` of the flash library (resolved once) with
    ``args`` and count the launch under ``counter``; raise on a CUDA error."""
    rc = _build.c_function(_LIBRARY.get(name, "flash_attention"), name, _ARGTYPES[name])(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    _build.LAUNCHES[counter] += 1


def fwd_block_rows(q: torch.Tensor) -> int:
    """K2's rows per block for q [BH, T, D] on its card: 16 if BH x
    ceil(T / 16) blocks fit one wave of its SMs, else 32."""
    dev = q.get_device()
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return 16 if q.shape[0] * -(-q.shape[1] // 16) <= sms else 32


def flash_fwd(q, k, v, bias, heads):
    """K2, or K2f for a full bias. q, k, v [BH, T, D]; bias None, [B, T] or
    [BH, T, T] -> (o, lse [BH, T])."""
    if _check(q, k, v, bias, heads):
        return flash_fwd_plain(q, k, v, bias, heads)
    return _fwd_launch(q, k, v, bias, heads, fwd_block_rows(q))


def _fwd_launch(q, k, v, bias, heads, rows: int):
    """Launch K2 (K2f) on checked CUDA inputs with ``rows`` (16 or 32) query
    rows per block."""
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device=q.device, dtype=torch.float32)
    name, counter = _entry("flash_fwd", "flash_fwd_bias", q, bias)
    _launch(name, counter, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), lse.data_ptr(), bh, t, d, heads, rows, d ** -0.5,
            _build.stream_of(q))
    return o, lse


def flash_dq(q, k, v, o, lse, g, bias, heads):
    """K3, or K3b for a full bias. g [N, T, D], N a multiple of BH ->
    (dq [N, T, D], dd [N, T], dbias): dbias = ds [N, T, T] for a full bias,
    else None."""
    if _check(q, k, v, bias, heads, o=o, lse=lse, g=g):
        return flash_dq_plain(q, k, v, o, lse, g, bias, heads)
    bh, t, d = q.shape
    n = g.shape[0]
    dq = torch.empty_like(g)
    dd = torch.empty((n, t), device=g.device, dtype=torch.float32)
    ptrs = [_ptr(x) for x in (q, k, v, o, lse, g, bias, dq, dd)]
    dbias = None
    if _is_full(bias):  # d(bias) float32 whatever q's dtype, as the reference's
        dbias = torch.empty((n, t, t), device=g.device, dtype=torch.float32)
        ptrs.append(dbias.data_ptr())
    _launch(*_entry("flash_dq", "flash_dq_dbias", q, bias), *ptrs, n, bh, t, d, heads,
            d ** -0.5, _build.stream_of(q))
    return dq, dd, dbias


def flash_dkv(q, k, v, lse, g, dd, bias, heads):
    """K4, or K4f for a full bias. dd as returned by K3 -> (dk, dv), each
    [N, T, D]."""
    if _check(q, k, v, bias, heads, lse=lse, g=g, dd=dd):
        return flash_dkv_plain(q, k, v, lse, g, dd, bias, heads)
    bh, t, d = q.shape
    n = g.shape[0]
    dk = torch.empty_like(g)
    dv = torch.empty_like(g)
    name, counter = _entry("flash_dkv", "flash_dkv_bias", q, bias)
    _launch(name, counter, *[_ptr(x) for x in (q, k, v, lse, g, dd, bias, dk, dv)],
            n, bh, t, d, heads, d ** -0.5, _build.stream_of(q))
    return dk, dv


# ------------------------------------------------------------ autograd

def _is_mask(bias: torch.Tensor) -> bool:
    return tuple(bias.shape[1:3]) == (1, 1)


def _kernel_bias(bias: Optional[torch.Tensor], b: int, h: int, t: int):
    """A rank-4 bias as the kernels take it: a [B, 1, 1, T] (or
    broadcastable) key mask -> contiguous [B, T]; any other, broadcast to
    [B, H, T, T] -> contiguous [BH, T, T]. Both float32."""
    if bias is None:
        return None
    if bias.ndim != 4:
        raise NotImplementedError(
            f"flash attention: a rank-4 bias expected, got {tuple(bias.shape)}")
    if _is_mask(bias):
        return _build.kernel_input(bias[:, 0, 0, :].expand(b, t).to(torch.float32))
    return _build.kernel_input(
        bias.expand(b, h, t, t).reshape(b * h, t, t).to(torch.float32))


def _unbroadcast(grad: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``grad`` over the axes that ``shape`` broadcast (size 1 there)."""
    for ax, (bs, gs) in enumerate(zip(shape, grad.shape)):
        if bs == 1 and gs != 1:
            grad = grad.sum(dim=ax, keepdim=True)
    return grad


def _fold_vmapped(x: Optional[torch.Tensor], dim: Optional[int], nv: int, b: int):
    """A rank-4 tensor of this vmap level with logical batch B (``dim`` its
    vmapped dim, or None) -> [V*B, ...], the vmapped axis outside B. An
    unbatched tensor is tiled V times, and one whose batch dim broadcasts
    (size 1: a shared mask or bias) is expanded to B first."""
    if x is None:
        return None
    x = x.movedim(dim, 0) if dim is not None else x.expand(nv, *x.shape)
    return x.expand(nv, b, *x.shape[2:]).reshape(nv * b, *x.shape[2:])


def _batch(x: torch.Tensor, dim: Optional[int]) -> int:
    """The logical leading size of ``x`` at a vmap level (``dim`` its
    vmapped dim, or None)."""
    return x.shape[1] if dim == 0 else x.shape[0]


class FlashBackward(torch.autograd.Function):
    """K3 then K4 (K3b then K4f for a full bias). g may carry V cotangents
    per residual row: its leading dim is V*B while the residuals' is B.
    Returns (dq, dk, dv, dbias); dbias is d(scores) [V*B, H, T, T] for a
    full bias, else None."""

    @staticmethod
    def forward(q, k, v, o, lse, g, bias):
        b, h, t, d = q.shape
        res = [_build.kernel_input(x.reshape(b * h, t, d)) for x in (q, k, v, o)]
        lse3 = _build.kernel_input(lse.reshape(b * h, t))
        g3 = _build.kernel_input(g.reshape(-1, t, d))
        kbias = _kernel_bias(bias, b, h, t)
        dq, dd, dbias = flash_dq(*res, lse3, g3, kbias, h)
        dk, dv = flash_dkv(*res[:3], lse3, g3, dd, kbias, h)
        outs = tuple(x.reshape(g.shape) for x in (dq, dk, dv))
        return outs + (None if dbias is None else dbias.reshape(g.shape[0], h, t, t),)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash backward has no second derivative here")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, g, bias):
        """Cotangent rows vmapped alone (the explainer's Jacobian) fold into
        g's leading dim, outside the residuals' B: row n reads residual row
        n % (B*H). Residuals vmapped too (a layer recomputed under a vmap
        over draws) fold into B as the forward's rule folds them, and g's R
        rows per residual row go outside that fold, so that the same
        indexing holds."""
        nv = info.batch_size
        res_dims = in_dims[:5] + in_dims[6:]
        if all(d is None for d in in_dims):
            return FlashBackward.apply(q, k, v, o, lse, g, bias), (None,) * 4
        if all(d is None for d in res_dims):
            g = g.movedim(in_dims[5], 0)
            flat = g.reshape((-1,) + g.shape[2:])                  # [V*N, H, T, D]
            dq, dk, dv, dbias = FlashBackward.apply(q, k, v, o, lse, flat, bias)
            unfold = lambda x: x.reshape((nv, g.shape[1]) + x.shape[1:])
            outs = tuple(unfold(x) for x in (dq, dk, dv))
            if dbias is None:
                return outs + (None,), (0, 0, 0, None)
            return outs + (unfold(dbias),), (0, 0, 0, 0)
        b = _batch(q, in_dims[0])
        qf, kf, vf, of = (_fold_vmapped(x, d, nv, b) for x, d in zip((q, k, v, o), in_dims))
        lsef = _fold_vmapped(lse[..., None], in_dims[4], nv, b)[..., 0]
        biasf = _fold_vmapped(bias, in_dims[6], nv, b)
        g = g.movedim(in_dims[5], 0) if in_dims[5] is not None else g.expand(nv, *g.shape)
        rows = g.shape[1] // b                                     # R, with N = R*B
        gf = g.reshape(nv, rows, b, *g.shape[2:]).transpose(0, 1).reshape(-1, *g.shape[2:])

        def unfold(x):                                             # [R*V*B, ...] -> [V, N, ...]
            x = x.reshape(rows, nv, b, *x.shape[1:]).transpose(0, 1)
            return x.reshape(nv, rows * b, *x.shape[3:])

        dq, dk, dv, dbias = FlashBackward.apply(qf, kf, vf, of, lsef, gf, biasf)
        outs = tuple(unfold(x) for x in (dq, dk, dv))
        return outs + (None if dbias is None else unfold(dbias),), \
            (0, 0, 0, None if dbias is None else 0)


class FlashAttention(torch.autograd.Function):
    """K2 (K2f) forward; K3/K4 (K3b/K4f) backward through ``FlashBackward``.

    Its ``vmap`` rule folds a vmapped axis (the draws of an explainer
    chunk) into B, so that one launch takes every draw; the node autograd
    records is then on the folded tensors, and the backward's cotangent
    rows fold outside them through ``FlashBackward``'s rule."""

    @staticmethod
    def forward(q, k, v, bias):
        b, h, t, d = q.shape
        q3, k3, v3 = (_build.kernel_input(x.reshape(b * h, t, d)) for x in (q, k, v))
        o3, lse = flash_fwd(q3, k3, v3, _kernel_bias(bias, b, h, t), h)
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
        dq, dk, dv, dfull = FlashBackward.apply(q, k, v, o, lse, g, bias)
        dbias = None
        # A full bias gets its d(bias) from K3b whether or not autograd asks
        # for it: what needs_input_grad reports inside torch.func transforms
        # is not verified, and the rel-pos layers always need it.
        if dfull is not None:
            dbias = _unbroadcast(dfull, bias.shape).to(bias.dtype)
        elif bias is not None and ctx.needs_input_grad[3]:
            dbias = torch.zeros_like(bias)  # masks are constants
        return dq, dk, dv, dbias

    @staticmethod
    def vmap(info, in_dims, q, k, v, bias):
        """Fold the vmapped axis into B: [V*B, H, T, D] through one launch,
        o and lse unfolded to [V, B, ...]. A bias comes as None, a [B or 1,
        1, 1, T] mask or a full bias, batched or shared; a shared one of
        batch 1 broadcasts over the fold as it is. With nothing vmapped at
        this level (a recomputed layer's unbatched inputs), the call runs
        as it is."""
        if all(d is None for d in in_dims):
            return FlashAttention.apply(q, k, v, bias), (None, None)
        nv = info.batch_size
        b = _batch(q, in_dims[0])
        qf, kf, vf = (_fold_vmapped(x, d, nv, b) for x, d in zip((q, k, v), in_dims))
        if bias is not None and (in_dims[3] is not None or bias.shape[0] != 1):
            bias = _fold_vmapped(bias, in_dims[3], nv, b)
        o, lse = FlashAttention.apply(qf, kf, vf, bias)
        return (o.reshape(nv, b, *o.shape[1:]), lse.reshape(nv, b, *lse.shape[1:])), (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over [B, H, T, D]; ``bias`` None, a [B, 1, 1, T] mask
    (constant) or a rank-4 score bias broadcastable to [B, H, T, T]
    (differentiable)."""
    return FlashAttention.apply(q, k, v, bias)[0]
