"""Collectives of tensor parallelism, written as autograd Functions.

Megatron-style tensor parallelism keeps the residual stream replicated on
the ranks of the tp group and splits each block's products between them:

  - column-parallel (qkv, fc_in): each rank multiplies by its columns (its
    heads, its slice of the MLP hidden width). The input goes in through
    ``copy_to``: the identity forward, and an all-reduce of its gradient,
    of which each rank holds the part through its own columns;
  - row-parallel (proj, fc_out): each rank multiplies its slice of the
    hidden width by its rows, which gives a partial sum; ``reduce_from``
    all-reduces it, and its gradient passes through as it is, since every
    rank holds the same downstream loss. The bias is added once, after the
    sum.

The vocabulary is split the same way: the embedding looks up the ids a rank
owns and ``reduce_from`` sums the rows; the cross-entropy takes the max,
the sum of exponentials and the target's logit over the group with
``all_reduce_`` (no gradient: the loss's backward is written out in
``models/gpt2.py``).

Under GSPMD the JAX package gets these collectives from the shardings
alone (``ray_tpu/parallel/sharding.py``); here the model calls them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The process group along one mesh axis (or several, flattened), its
    size and this rank's index in it."""

    group: dist.ProcessGroup
    size: int
    rank: int


def all_reduce_(x: torch.Tensor, axis: AxisGroup, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over the axis; returns ``x``. Not differentiable."""
    dist.all_reduce(x, op=op, group=axis.group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """Enter a tensor-parallel region: the identity, whose gradient is
    summed over the axis. ``axis`` None (no tensor parallelism): ``x``."""
    return x if axis is None else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """Leave a tensor-parallel region: the sum of the ranks' partial
    results, whose gradient passes through. ``axis`` None: ``x``."""
    return x if axis is None else _ReduceFrom.apply(x, axis)
