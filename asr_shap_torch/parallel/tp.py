"""Tensor parallelism: Megatron's split of the params over the mesh's
model axis.

The key-path rule is the reference's (``asr_shap/parallel/tp.py``):

  * kernels under q, k, v, intermediate and pw1 shard their output features
    (last axis), and so do their biases: column-parallel, heads split
    across ranks (num_heads % model_parallel == 0);
  * kernels under out, output and pw2 shard their input features
    (second-to-last axis), and their biases replicate: row-parallel;
  * everything else replicates (norms, convs, positions, heads).

The reference leaves the collectives to GSPMD. Here the forward places
them, as Megatron does, through two ``autograd.Function``s: ``copy_to_tp``
before a column-parallel linear (identity forward, all_reduce of the
gradient's partial sums backward) and ``reduce_from_tp`` after a
row-parallel one (all_reduce forward, identity backward), the bias added
after the reduce. Where a module needs the full width of a column-parallel
output (the conformer's GLU) or this rank's slice of a replicated one (its
pw2 input), a zero-padded ``reduce_from_tp`` gathers and a ``copy_to_tp``
then a slice scatters, so that these two are the only collectives. Each
Function has a ``vmap`` rule that reduces the physical tensor: c10d ops have
no batching rule, and the explainer's cotangent rows reach them under
``torch.func.vmap``. With no mesh the models call none of this.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from asr_shap_torch.ops.remat import dot
from asr_shap_torch.parallel.mesh import Mesh

# keys whose kernels shard output features (last axis); their biases shard too
_SHARD_OUT = ("q", "k", "v", "intermediate", "pw1")
# keys whose kernels shard input features (second-to-last axis); bias replicated
_SHARD_IN = ("out", "output", "pw2")


def spec_for(path: Tuple[Any, ...], ndim: int, model_axis: str = "model") -> tuple:
    """The partition of the leaf at ``path`` (its dict keys and list
    indices) with ``ndim`` dims: per dim, ``model_axis`` or None; ``()``
    replicates. The entries of the reference's PartitionSpec."""
    keys = [p if isinstance(p, str) else None for p in path]
    name = keys[-1] if keys else None
    parent = keys[-2] if len(keys) >= 2 else None
    axis = None
    if name == "kernel" and parent in _SHARD_OUT:
        axis = ndim - 1
    elif name == "kernel" and parent in _SHARD_IN and ndim >= 2:
        axis = ndim - 2
    elif name == "bias" and parent in _SHARD_OUT and ndim >= 1:
        axis = ndim - 1
    if axis is None:
        return ()
    return tuple(model_axis if i == axis else None for i in range(ndim))


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tp_specs(params, model_axis: str = "model"):
    """The partition of every leaf of ``params`` (``spec_for``), as a tree
    of the same shape."""
    return _map_with_path(lambda path, leaf: spec_for(path, leaf.ndim, model_axis), params)


def shard_params_tp(params, mesh: Mesh):
    """This rank's local shards of ``params`` on the mesh's model axis: each
    sharded leaf's contiguous block ``model_rank`` of ``model_size`` along
    its sharded dim, the rest as they are."""
    mp, r = mesh.model_size, mesh.model_rank

    def shard(path, leaf):
        spec = spec_for(path, leaf.ndim)
        if not spec:
            return leaf
        dim = spec.index("model")
        if leaf.shape[dim] % mp:
            raise ValueError(f"{'/'.join(map(str, path))}: dim {dim} of {tuple(leaf.shape)} "
                             f"does not split over {mp} model ranks")
        k = leaf.shape[dim] // mp
        return leaf.narrow(dim, r * k, k).contiguous()

    return _map_with_path(shard, params)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _ReduceFromTP(torch.autograd.Function):
    """all_reduce (SUM) over the model axis forward, identity backward."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromTP.apply(x, group), in_dims[0]


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all_reduce (SUM) of the gradient over the model
    axis backward."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromTP.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToTP.apply(x, group), in_dims[0]


def copy_to_tp(x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    """Enter a column-parallel region; ``x`` itself without a mesh."""
    return x if tp is None else _CopyToTP.apply(x, tp.model_group)


def reduce_from_tp(x: torch.Tensor, tp: Mesh) -> torch.Tensor:
    """Sum the model ranks' partial results of a row-parallel region."""
    return _ReduceFromTP.apply(x, tp.model_group)


def row_linear(p, x: torch.Tensor, tp: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel linear: this rank's partial product, reduced, then
    the (replicated) bias once. Without a mesh, the plain linear."""
    y = dot(x, p["kernel"])
    if tp is not None:
        y = reduce_from_tp(y, tp)
    if "bias" in p:
        y = y + p["bias"]
    return y


def gather_last(x: torch.Tensor, tp: Mesh) -> torch.Tensor:
    """The full last axis of a column-parallel output: this rank's block
    zero-padded into place, summed over the model axis."""
    k = x.shape[-1]
    r, mp = tp.model_rank, tp.model_size
    return reduce_from_tp(F.pad(x, (r * k, (mp - 1 - r) * k)), tp)


def scatter_last(x: torch.Tensor, tp: Mesh) -> torch.Tensor:
    """This rank's block of the last axis of a replicated ``x``, entering a
    row-parallel region (its gradient is summed over the model axis)."""
    k = x.shape[-1] // tp.model_size
    return copy_to_tp(x, tp)[..., tp.model_rank * k:(tp.model_rank + 1) * k]
