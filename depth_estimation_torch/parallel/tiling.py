"""Row-stripe tile parallelism with halo exchange (counterpart of the JAX
package's `parallel/tiling.py`).

The image plane is split into row stripes along a mesh axis, one stripe a
rank. Every local operator of finite spatial support (box aggregation,
guided filter, the bilateral lattice with its short position kernel) runs
on a stripe padded with `halo` rows from each neighbour, and the halo is
then discarded: overlap-and-discard, one neighbour exchange per operand and
no communication inside the operator. The JAX package runs the same local
functions under `shard_map`; here they take and return this rank's stripe,
and `gather_rows` assembles the whole array on every rank.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import Mesh, _wire

__all__ = ["halo_exchange_rows", "tiled_apply", "tiled_filter_hwc", "gather_rows"]


def halo_exchange_rows(x_local: torch.Tensor, halo: int, mesh: Mesh,
                       axis: str = "tile") -> torch.Tensor:
    """Pad this rank's (h_local, ...) stripe with `halo` rows from each
    neighbour along `axis` (zero rows at the outer edges). Returns
    (h_local + 2·halo, ...). Collective over the axis' ranks."""
    idx, num = mesh.axis_index(axis), mesh.axis_size(axis)
    top, bot = x_local[:halo], x_local[-halo:]  # sent up, sent down
    above, below = torch.zeros_like(top), torch.zeros_like(top)
    if num > 1:
        ranks, group = mesh.axis_ranks(axis), mesh.group(axis)
        # under gloo the strips travel as host copies (`mesh._wire`)
        send_top, send_bot = _wire(mesh, top.contiguous()), _wire(mesh, bot.contiguous())
        recv_above, recv_below = _wire(mesh, above), _wire(mesh, below)
        ops = []
        if idx > 0:
            ops += [dist.P2POp(dist.isend, send_top, ranks[idx - 1], group),
                    dist.P2POp(dist.irecv, recv_above, ranks[idx - 1], group)]
        if idx < num - 1:
            ops += [dist.P2POp(dist.isend, send_bot, ranks[idx + 1], group),
                    dist.P2POp(dist.irecv, recv_below, ranks[idx + 1], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        above, below = recv_above.to(x_local.device), recv_below.to(x_local.device)
    return torch.cat([above, x_local, below])


def _crop(out: torch.Tensor, halo: int) -> torch.Tensor:
    return out[halo:out.shape[0] - halo]


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x_local: torch.Tensor, halo: int,
                mesh: Mesh, axis: str = "tile") -> torch.Tensor:
    """`fn`, an (h, ...) → (h, ...) local operator, on this rank's stripe
    with overlap-and-discard halos; returns this rank's output stripe."""
    return _crop(fn(halo_exchange_rows(x_local, halo, mesh, axis)), halo)


def tiled_filter_hwc(filter_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                     src_local: torch.Tensor, guide_local: torch.Tensor, halo: int, mesh: Mesh,
                     axis: str = "tile") -> torch.Tensor:
    """A pixel-space filter `filter_fn(src, guide) -> out` (all (h, w, c))
    on this rank's stripes, with halo exchange of both operands: each rank
    builds the lattice of its own padded stripe."""
    return _crop(filter_fn(halo_exchange_rows(src_local, halo, mesh, axis),
                           halo_exchange_rows(guide_local, halo, mesh, axis)), halo)


def gather_rows(x_local: torch.Tensor, mesh: Mesh, axis: str = "tile") -> torch.Tensor:
    """The stripes of every rank along `axis`, concatenated in axis order on
    every rank (the whole array of a row-sharded output)."""
    if mesh.axis_size(axis) == 1:
        return x_local
    buf = _wire(mesh, x_local.contiguous())
    parts = [torch.empty_like(buf) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    return torch.cat(parts).to(x_local.device)
