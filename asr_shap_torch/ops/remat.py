"""Per-layer rematerialization: the reference's ``jax.checkpoint`` around
each encoder layer.

``checkpoint_layer(fn, x, aux, layer, policy)`` runs ``fn(x, *aux, layer)``
through ``Recompute``, an ``autograd.Function`` that keeps the layer's
inputs and, under the "dots" policy, the outputs of its products without
batch dims, and nothing else; its backward runs the layer again under
``torch.func.vjp`` and pulls the cotangent through it. The same Function
serves both callers of a backward:

  * the explainers' ``torch.func`` transforms (a VJP, the cotangent rows
    vmapped through it, the draws of a chunk vmapped under it): the
    Function generates its vmap rule, so the recompute runs per draw and
    every custom Function inside the layer meets the draws at its own vmap
    rule (the flash kernels fold them into B);
  * plain autograd (training): the layer's param leaves are explicit
    inputs, so their gradients flow from the recompute's VJP.

``torch.utils.checkpoint`` is not used: its saved-tensor hooks do not run
under ``torch.func``'s VJP. The backward takes gradients only of the
inputs autograd asks for, so the explainer, whose params do not require
grad, forms no weight gradient.

Policies, as the reference's ``remat_policy``:

  * "full": only the layer's inputs are kept; the whole layer (attention
    included) runs again in the backward;
  * "dots": the outputs of the layer's products without batch dims (the
    linears, through ``dot``; ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` in the reference) are kept too, and
    the recompute replays them instead of multiplying again; the rest,
    attention included, runs again.

An unknown policy raises; with grad off (no backward can follow) the layer
runs directly.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from asr_shap_torch.kernels import gemm

REMAT_POLICIES = ("full", "dots")

# the "dots" recorder or replayer of the layer running now, read by ``dot``:
# every model family's linears reach it without a parameter of their own;
# thread-local and set only inside ``_taping``
_tape = threading.local()


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight ``w`` [in, out]: a product without batch dims,
    which a "dots" forward records and its recompute replays. Where its
    input gradient will take the 3xTF32 kernel (``gemm.takes``: the
    operands' dtype and device and the precision, all known now), the
    product is ``Dot``; elsewhere the plain ``x @ w``, with no Function's
    cost on the host."""
    tape = getattr(_tape, "active", None)
    if tape is not None:
        return tape(x, w)
    return Dot.apply(x, w) if gemm.takes(x, w) else x @ w


def _dot_grads(ctx, x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The gradients of ``x @ w`` that autograd asks for. The input gradient
    ``g @ w.T`` runs the 3xTF32 kernel where ``gemm.takes`` it (float32 on
    the card under "highest"), else ``torch.matmul``; the weight gradient,
    which only training forms, stays on ``torch.matmul``."""
    gx = gw = None
    if ctx.needs_input_grad[0]:
        gx = gemm.GemmNT.apply(g, w) if gemm.takes(g, w) else g @ w.transpose(0, 1)
    if ctx.needs_input_grad[1]:
        gw = x.reshape(-1, x.shape[-1]).transpose(0, 1) @ g.reshape(-1, g.shape[-1])
    return gx, gw


class Dot(torch.autograd.Function):
    """``x @ w``, with the gradients of ``_dot_grads``."""

    @staticmethod
    def forward(x, w):
        return x @ w

    @staticmethod
    def setup_context(ctx, inputs, output):
        # x only for the weight gradient, as autograd's own matmul keeps it
        x, w = inputs
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _dot_grads(ctx, x, w, g)

    @staticmethod
    def vmap(info, in_dims, x, w):
        """A vmapped ``x`` (the draws of a chunk) keeps its vmapped dimension
        where it is, as one more leading dimension of the product (moved
        first only if it is the last): one product, and autograd's node on
        the physical tensors, whose backward meets the cotangent rows at
        ``GemmNT``'s rule."""
        if in_dims[1] is not None:
            raise NotImplementedError("dot: batched weights under vmap")
        x, dim = gemm.leading_vmapped(x, in_dims[0])
        return Dot.apply(x, w), dim


@contextlib.contextmanager
def _taping(fn: Optional[Callable]):
    before = getattr(_tape, "active", None)
    _tape.active = fn
    try:
        yield
    finally:
        _tape.active = before


class SavedDot(torch.autograd.Function):
    """``x @ w`` whose value ``y`` the forward already computed: returns it
    as it is, with the product's gradients in the backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, y):
        return y.view_as(y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*_dot_grads(ctx, x, w, g), None)


def _replay(saved: Sequence[torch.Tensor]):
    it = iter(saved)

    def tape(x, w):
        y = next(it, None)
        if y is None:
            raise RuntimeError("remat 'dots': the recompute made more products than "
                               "its forward")
        return SavedDot.apply(x, w, y)

    return tape, it


class Recompute(torch.autograd.Function):
    """``fn(x, *args)`` that keeps only its inputs (and, under "dots", its
    products' outputs, returned after the layer's output) and recomputes
    the rest in its backward."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, policy, x, *args):
        if policy != "dots":
            return (fn(x, *args),)
        saved: List[torch.Tensor] = []

        def record(a, w):
            y = a @ w
            saved.append(y)
            return y

        with _taping(record):
            y = fn(x, *args)
        return (y, *saved)

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, policy, x, *args = inputs
        ctx.fn = fn
        ctx.n_inputs = 1 + len(args)
        ctx.mark_non_differentiable(*output[1:])
        ctx.save_for_backward(x, *args, *output[1:])

    @staticmethod
    def backward(ctx, gy, *_):
        saved = ctx.saved_tensors
        inputs, dots = list(saved[:ctx.n_inputs]), saved[ctx.n_inputs:]
        want = [i for i in range(ctx.n_inputs) if ctx.needs_input_grad[2 + i]]

        def run(*diff):
            call = list(inputs)
            for i, t in zip(want, diff):
                call[i] = t
            if not dots:
                return ctx.fn(*call)
            tape, rest = _replay(dots)
            with _taping(tape):
                y = ctx.fn(*call)
            if next(rest, None) is not None:
                raise RuntimeError("remat 'dots': the recompute made fewer products "
                                   "than its forward")
            return y

        _, vjp_fn = torch.func.vjp(run, *[inputs[i] for i in want])
        grads = vjp_fn(gy)
        out: List[Optional[torch.Tensor]] = [None] * (2 + ctx.n_inputs)
        for i, g in zip(want, grads):
            out[2 + i] = g
        return tuple(out)


def _flatten(tree: Any, leaves: List[torch.Tensor]):
    """The tensor leaves of a nested dict/list/tuple (appended to
    ``leaves``) and a function that rebuilds the tree from a new list."""
    if isinstance(tree, dict):
        parts = [(k, _flatten(v, leaves)) for k, v in tree.items()]
        return lambda it: {k: p(it) for k, p in parts}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, leaves) for v in tree]
        return lambda it: type(tree)(p(it) for p in parts)
    if torch.is_tensor(tree):
        leaves.append(tree)
        return lambda it: next(it)
    return lambda it: tree


def checkpoint_layer(fn: Callable[..., torch.Tensor], x: torch.Tensor,
                     aux: Tuple[Optional[torch.Tensor], ...], layer: Any,
                     policy: str = "full") -> torch.Tensor:
    """``fn(x, *aux, layer)`` with its activations recomputed in the
    backward (``Recompute``). ``aux`` holds the layer's other tensors (a
    mask, a position table; None allowed), ``layer`` its params tree,
    whose tensor leaves enter as inputs of their own."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}: one of {REMAT_POLICIES}")
    if not torch.is_grad_enabled():
        return fn(x, *aux, layer)
    leaves: List[torch.Tensor] = []
    rebuild = _flatten(layer, leaves)
    n_aux = len(aux)

    def call(h, *rest):
        return fn(h, *rest[:n_aux], rebuild(iter(rest[n_aux:])))

    return Recompute.apply(call, policy, x, *aux, *leaves)[0]
