"""Collectives with their transposes, for the tensor- and expert-parallel layers.

The JAX package writes none of these: GSPMD inserts the tensor split's
all-reduces itself, and ``shard_map`` differentiates ``psum`` and
``all_to_all``. Here each is a ``torch.autograd.Function``:

- :func:`copy_to_group` at the input of a column-parallel region: the
  identity forward, an all-reduce of the gradient over the group backward
  (each rank's slice of the columns contributes its part of the input's
  gradient);
- :func:`reduce_from_group` after a row-parallel product: an all-reduce of
  the partial sums forward, the identity backward;
- :func:`all_to_all` over equal chunks of dim 0: chunk ``j`` goes to the
  group's rank ``j``, and the chunk from rank ``i`` lands at ``i``. Its
  transpose is the same exchange;
- :func:`sum_over_group` for a statistic that every rank's loss reads (the
  global batch's BatchNorm sums): an all-reduce forward, and an all-reduce
  of the gradient backward, since each rank's part reaches every rank's
  loss.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to_group(x, group):
    """x forward; the gradient all-reduced over ``group`` backward (x itself
    for ``group`` None: a layer that is not split)."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """x all-reduced (summed) over ``group`` forward; the gradient as it is
    backward (x itself for ``group`` None)."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def all_to_all(x, group):
    """x's dim 0, in equal chunks, exchanged over ``group`` (dim 0 must be a
    multiple of the group's size)."""
    n = dist.get_world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is not a multiple of {n} ranks")
    return _AllToAll.apply(x, group)


def sum_over_group(x, group):
    """x summed over ``group`` forward, and its gradient summed over
    ``group`` backward (x itself for ``group`` None)."""
    return x if group is None else _SumOverGroup.apply(x, group)
