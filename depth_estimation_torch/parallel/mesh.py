"""A (data, tile) mesh over the ranks of a `torch.distributed` world
(counterpart of the JAX package's `parallel/mesh.py`).

The JAX package lays one `jax.sharding.Mesh` with named axes over every
device and lets XLA insert the collectives. Here each process is one rank;
the ranks form a data × tile grid, rank = d·tile + t, and every row and
column of the grid has its own process group:

  - 'data': batch data parallelism. A rank takes its rows of a batch's
    leading axis (`shard_batch`, the counterpart of `data_sharding`),
    parameters come from the axis' rank 0 (`broadcast_`, the counterpart
    of `replicated`) and gradients are averaged over the axis (`all_mean_`);
  - 'tile': row stripes of the image plane with halo exchange
    (`parallel.tiling`).

The backend is the caller's choice and is never inferred. Several ranks
that share one GPU must use 'gloo': NCCL refuses two ranks on one device.
Gloo moves host memory, so under gloo a CUDA tensor is communicated
through a host copy (`_wire`); NCCL takes it as it is. Without an
initialised world, `make_mesh` gives a 1 × 1 mesh on which every
collective is the identity.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["distributed_init", "make_mesh", "Mesh", "shard_batch", "broadcast_", "all_mean_"]

AXES = ("data", "tile")


def distributed_init(backend: str, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None) -> bool:
    """Join a `torch.distributed` world with `backend` ('gloo' or 'nccl').

    `init_method` defaults to `env://` when `MASTER_ADDR` is set, and
    `world_size` and `rank` to `WORLD_SIZE` and `RANK`. Returns False, and
    joins nothing, when neither an init method nor `MASTER_ADDR` is given:
    the single-process case, where `make_mesh` gives a 1 × 1 mesh."""
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return False
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return True


class Mesh:
    """The (data, tile) grid of the world's ranks and one process group per
    row and per column. Every rank must build the mesh, in the same order
    as its other groups: `dist.new_group` is collective."""

    def __init__(self, data: int, tile: int):
        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        if data < 1 or tile < 1 or data * tile != world:
            raise ValueError(f"a {data} × {tile} mesh needs {data * tile} ranks, the world has {world}")
        self.shape = {"data": data, "tile": tile}
        self.rank = dist.get_rank() if live else 0
        self.backend = dist.get_backend() if live else None
        d, t = divmod(self.rank, tile)
        self._index = {"data": d, "tile": t}
        lines = {"data": [[i * tile + j for i in range(data)] for j in range(tile)],
                 "tile": [[i * tile + j for j in range(tile)] for i in range(data)]}
        self._ranks = {"data": lines["data"][t], "tile": lines["tile"][d]}
        self._groups = {}
        for axis in AXES:
            if self.shape[axis] == 1:
                continue  # a one-rank axis communicates nothing
            for ranks in lines[axis]:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's place along `axis`."""
        return self._index[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks of this rank's line along `axis`, in axis order."""
        return self._ranks[axis]

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(data: int | None = None, tile: int = 1) -> Mesh:
    """A (data, tile) mesh over the whole world (data defaults to
    world / tile)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return Mesh(world // tile if data is None else data, tile)


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor to hand to the backend: a host copy of a CUDA tensor under
    gloo, which moves host memory; the tensor itself otherwise."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def shard_batch(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of `x`'s leading axis, which must divide evenly
    over `axis` (as a `NamedSharding` demands)."""
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    B = x.shape[0]
    if B % n:
        raise ValueError(f"a leading axis of {B} does not divide over {n} '{axis}' ranks")
    return x[i * (B // n):(i + 1) * (B // n)]


@torch.no_grad()
def broadcast_(tensors, mesh: Mesh, axis: str = "data"):
    """Overwrite each tensor with its value on the axis' rank 0, in place."""
    if mesh.axis_size(axis) == 1:
        return tensors
    for t in tensors:
        buf = _wire(mesh, t.detach())
        dist.broadcast(buf, src=mesh.axis_ranks(axis)[0], group=mesh.group(axis))
        if buf.device != t.device:
            t.copy_(buf)
    return tensors


@torch.no_grad()
def all_mean_(tensors, mesh: Mesh, axis: str = "data"):
    """Replace each tensor by its mean over the axis' ranks, in place."""
    n = mesh.axis_size(axis)
    if n == 1:
        return tensors
    for t in tensors:
        buf = _wire(mesh, t.detach())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group(axis))
        t.copy_(buf / n)
    return tensors
