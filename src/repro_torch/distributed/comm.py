"""Collectives with the gradients the mesh code needs.

Each is a ``torch.autograd.Function`` over one process group (a mesh axis's
line).  The convention is Megatron's: a value every rank of the group holds
alike (replicated) has the same cotangent on every rank, so a sum's
backward hands its cotangent on unchanged and a copy's backward sums the
ranks' partial cotangents.

  all_gather(t, dim, group, reduce)  the whole tensor from each rank's block
                                     along ``dim``; backward reduce-scatters
                                     (sums) the cotangent back to the block,
                                     or slices it when ``reduce`` is off
                                     (every rank computed the same thing)
  reduce_sum(t, group)               all-reduce (sum); backward identity
  reduce_scatter(t, dim, group)      the sum of the ranks' tensors, this rank's
                                     block of it along ``dim``; backward
                                     all-gathers the blocks' cotangents
  split(t, dim, group)               this rank's block of a tensor every rank
                                     holds alike; backward all-gathers
  all_max(t, group)                  all-reduce (max), outside autograd (the
                                     log-sum-exp's shift, which carries no
                                     gradient)
  copy_to(t, group)                  identity; backward all-reduce (sum)
  mean(t, group, scale_grad)         all-reduce mean; backward divides the
                                     cotangent by the group's size when
                                     ``scale_grad`` (each rank's loss holds
                                     the mean once and the ranks' gradients
                                     are summed), else passes it on
  scale_grad(t, s)                   identity; backward multiplies by ``s``
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _scatter(g: torch.Tensor, dim: int, group, reduce: bool) -> torch.Tensor:
    n = dist.get_world_size(group)
    src = g.movedim(dim, 0).contiguous()
    if reduce:
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    else:
        out = src.chunk(n)[dist.get_rank(group)].clone()
    return out.movedim(0, dim)


class _AllGather(Function):

    @staticmethod
    def forward(ctx, t, dim, group, reduce):
        ctx.args = (dim, group, reduce)
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceSum(Function):

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceScatter(Function):

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.args = (dim, group)
        return _scatter(t, dim, group, True)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


class _Split(Function):

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.args = (dim, group)
        return _scatter(t, dim, group, False)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None


class _CopyTo(Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        # a view: a backend may still hold the buffer, and whether a leaf's
        # gradient accumulation then takes it or copies it would depend on
        # when the backend lets it go
        return g.view_as(g), None


class _Mean(Function):

    @staticmethod
    def forward(ctx, t, group, scale_grad):
        n = dist.get_world_size(group)
        ctx.scale = 1.0 / n if scale_grad else 1.0
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None


class _ScaleGrad(Function):

    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def all_gather(t: torch.Tensor, dim: int, group, reduce: bool = True) -> torch.Tensor:
    return _AllGather.apply(t, dim, group, reduce)


def reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _ReduceSum.apply(t, group)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _ReduceScatter.apply(t, dim, group)


def split(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _Split.apply(t, dim, group)


@torch.no_grad()
def all_max(t: torch.Tensor, group) -> torch.Tensor:
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(t, group)


def mean(t: torch.Tensor, group, scale_grad: bool = True) -> torch.Tensor:
    return _Mean.apply(t, group, scale_grad)


def scale_grad(t: torch.Tensor, s: float) -> torch.Tensor:
    return _ScaleGrad.apply(t, s)
