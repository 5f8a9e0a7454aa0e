"""The collectives of the data axis: a differentiable sum all-reduce, one
all-reduce over every gradient of a step, and a gather of host arrays.

On CUDA tensors only `all_reduce` and `broadcast` are used: two ranks that
share one card run over gloo, whose CUDA support covers those two.  Host
arrays go over a gloo group as CPU tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of x over the group's ranks, differentiable.  The backward sums
    the cotangents over the group as well: each rank's loss is its share of
    the global loss, so the global loss's cotangent of a summed tensor is
    the sum of the ranks' cotangents.  (torch.distributed.nn's all_reduce
    does this too, but is deprecated.)"""
    return _AllReduceSum.apply(x, group)


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> list[torch.Tensor]:
    """Every gradient summed over the group in one collective on one flat
    buffer (summed, not averaged: each rank's gradient is that of its share
    of the global loss).  Returns new tensors shaped as the inputs."""
    dtypes = {g.dtype for g in grads}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_grads: one dtype expected, got {sorted(map(str, dtypes))}")
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [t.view_as(g) for t, g in zip(flat.split([g.numel() for g in grads]), grads)]


def host_gather(array: np.ndarray, group) -> list[np.ndarray]:
    """Every rank's `array`, in rank order, on every rank.  `group` is a
    gloo group; the arrays have one shape and dtype on all ranks."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.numpy() for o in out]
