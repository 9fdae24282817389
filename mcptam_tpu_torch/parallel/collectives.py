"""The collectives of the sharded paths (parallel/mesh.py) and the modules
they reach: a sum, minimum or maximum over the ranks of a process group,
and all-gathers in rank order.  Only ``dist.all_reduce`` and the list form
of ``dist.all_gather`` are used: NCCL carries both on CUDA tensors, gloo
on CPU tensors (and CUDA tensors, staged through the host).

With ``group=None`` every function here is the identity and issues no
collective, so a function that takes an optional group computes exactly
what it computed without one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def rank_world(group) -> tuple:
    """(this process's rank, the number of ranks) in ``group``; (0, 1)
    for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_range(n: int, group, what: str) -> tuple:
    """The [lo, hi) slice of an axis of ``n`` items that this rank owns:
    equal contiguous blocks in rank order.  Raises ValueError, naming the
    size, when ``n`` does not divide by the number of ranks."""
    rank, world = rank_world(group)
    if n % world:
        raise ValueError(f"{what} = {n} does not divide by the {world} ranks of the mesh")
    per = n // world
    return rank * per, (rank + 1) * per


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: ``x`` reduced over the ranks with ``op`` (sum, min or
    max); ``x`` itself for group None."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        raise TypeError("all_reduce takes numbers; reduce a bool tensor's count")
    y = x.reshape(-1).clone()
    dist.all_reduce(y, op=_OPS[op], group=group)
    return y.reshape(x.shape)


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` (of one shape on all), in rank order; [x] for
    group None.  A bool tensor travels as uint8."""
    if group is None:
        return [x]
    src = x.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(torch.bool) for o in out] if x.dtype == torch.bool else out


def gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if group is None:
        return x
    return torch.cat(all_gather(x, group), dim)


def from_owner(x: torch.Tensor, owner: torch.Tensor, group) -> torch.Tensor:
    """Item k of a (K, ...) tensor that every rank computed, each rank
    right only for the items it owns, taken from rank ``owner[k]``: the
    values are moved, never added, so the result is exact."""
    if group is None:
        return x
    stacked = torch.stack(all_gather(x, group))            # (world, K, ...)
    return stacked[owner.long(), torch.arange(x.shape[0], device=x.device)]
