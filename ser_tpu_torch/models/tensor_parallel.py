"""Megatron's tensor-parallel operators over a model-axis process group.

A column-parallel product holds this rank's rows of the weight (its slice of
the output features), a row-parallel product this rank's columns (its slice
of the input features), so one block needs one sum over the group after each
row-parallel product. Megatron's two conjugate operators put the collectives
where autograd needs them:

- ``f`` (:func:`copy_to_model_group`): identity forward, all-reduce of the
  gradient backward; it stands before each column-parallel product, whose
  input every rank holds whole;
- ``g`` (:func:`reduce_from_model_group`): all-reduce forward, identity
  backward; it stands after each row-parallel product, whose partial sums it
  adds up.

:func:`local_slice` hands a column-parallel product this rank's slice of a
bias that every rank holds whole (the JAX package replicates every
tensor that is not 2-D); its backward sums the slices' gradients over the
group, so the whole bias gets its whole gradient on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(tensor: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    out = tensor.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _LocalSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whole, group):
        ctx.group = group
        ctx.parts, ctx.index = dist.get_world_size(group), dist.get_rank(group)
        return whole.chunk(ctx.parts)[ctx.index].clone()

    @staticmethod
    def backward(ctx, grad):
        whole = grad.new_zeros((grad.shape[0] * ctx.parts, *grad.shape[1:]))
        whole.chunk(ctx.parts)[ctx.index].copy_(grad)
        dist.all_reduce(whole, group=ctx.group)
        return whole, None


def copy_to_model_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Megatron's ``f``: identity forward, all-reduce backward."""
    return _CopyToModelGroup.apply(x, group)


def reduce_from_model_group(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """Megatron's ``g``: all-reduce forward, identity backward."""
    return _ReduceFromModelGroup.apply(x, group)


def local_slice(whole: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """This rank's slice of dim 0 of a tensor every rank holds whole; the gradient is summed over the group."""
    return _LocalSlice.apply(whole, group)


__all__ = ["copy_to_model_group", "local_slice", "reduce_from_model_group"]
