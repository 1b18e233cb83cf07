"""A (data, model) mesh of ``torch.distributed`` processes.

The reference lays its devices out as ``np.reshape(devices, (dp, mp))``
and names the axes ``MeshConfig.data_axis`` and ``model_axis``; here each
device is one process (one rank of an initialized process group, on its own
card or the CPU). Rank ``d * mp + m`` of the group is at data index ``d``
and model index ``m``. A ``Mesh`` holds the group, this rank's data-axis
subgroup (the ranks of its model index: the draws and the samples shard
over it) and model-axis subgroup (the ranks of its data index: the params
split over it, ``parallel/tp.py``), its index on each axis, and the
``torch.device`` it computes on. Collectives go through all_reduce and
broadcast only, which gloo takes for CUDA tensors too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from asr_shap_torch.core.config import MeshConfig
from asr_shap_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    group: dist.ProcessGroup        # the mesh's ranks
    ranks: tuple                    # global ranks, [dp, mp] row-major
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup
    data_rank: int
    model_rank: int
    data_size: int
    model_size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh: the one that decides and writes."""
        return self.data_rank == 0 and self.model_rank == 0

    def data_src(self, d: int) -> int:
        """The global rank at data index ``d`` on this rank's model index
        (a broadcast's source on the data axis)."""
        return self.ranks[d * self.model_size + self.model_rank]


def make_mesh(config: MeshConfig = MeshConfig(), group: Optional[dist.ProcessGroup] = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of ``config`` over an initialized process group (default
    the world): ``data_parallel`` 0 takes world size // ``model_parallel``
    ranks; a mesh larger than the group raises ValueError. Every rank of
    the group calls it (the subgroups are made collectively); a rank left
    outside a smaller mesh raises after that."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process "
                           "group (init_mesh_from_env, or init_process_group)")
    group = group or dist.group.WORLD
    world = dist.get_process_group_ranks(group)
    n = len(world)
    mp = max(1, config.model_parallel)
    dp = config.data_parallel if config.data_parallel > 0 else n // mp
    if dp < 1 or dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {n}")
    grid = np.asarray(world[:dp * mp]).reshape(dp, mp)
    me = dist.get_rank()
    data_group = model_group = None
    for m in range(mp):
        g = dist.new_group([int(r) for r in grid[:, m]])
        if me in grid[:, m]:
            data_group = g
    for d in range(dp):
        g = dist.new_group([int(r) for r in grid[d]])
        if me in grid[d]:
            model_group = g
    if me not in grid:
        raise ValueError(f"rank {me} is outside the {dp}x{mp} mesh of {n} ranks")
    d, m = (int(v[0]) for v in np.nonzero(grid == me))
    return Mesh(group=group, ranks=tuple(int(r) for r in grid.ravel()),
                data_group=data_group, model_group=model_group, data_rank=d,
                model_rank=m, data_size=dp, model_size=mp, device=resolve_device(device))


def init_mesh_from_env(config: MeshConfig = MeshConfig(), backend: Optional[str] = None,
                       device: str = "cuda") -> Mesh:
    """The mesh of a torchrun launch: the process group from ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (unless one is
    initialized already), each rank on ``cuda:LOCAL_RANK``, or on the CPU
    when ``device`` is "cpu". ``backend`` defaults to NCCL on CUDA and gloo
    on the CPU."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing and not dist.is_initialized():
        raise RuntimeError(f"no torchrun environment: {', '.join(missing)} not set")
    if torch.device(device).type == "cuda":
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return make_mesh(config, device=dev)


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis`` over the data axis (the
    reference's ``data_sharding``); the axis must divide evenly."""
    n = x.shape[axis]
    if n % mesh.data_size:
        raise ValueError(f"axis {axis} of size {n} does not split over "
                         f"{mesh.data_size} data ranks")
    k = n // mesh.data_size
    return x.narrow(axis, mesh.data_rank * k, k)


def data_mean(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced, in place, by its mean over the data axis, the same
    bits on every rank: an all-reduce sum over this rank's data-axis group,
    divided by the axis size. Returns ``x``."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return x.div_(mesh.data_size)


def replicate(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Mesh rank 0's ``x`` on every rank (the reference's ``replicated``):
    a broadcast into a copy of ``x`` on the mesh's device."""
    out = x.detach().to(mesh.device, copy=True).contiguous()
    dist.broadcast(out, src=mesh.ranks[0], group=mesh.group)
    return out
