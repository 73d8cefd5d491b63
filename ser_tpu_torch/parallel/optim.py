"""Optimizers of the training step: plain functions on named tensors.

Counterparts of the optax optimizers that ``ser_tpu.parallel.train_step``
and its training script use, at their defaults and with their arithmetic in the same
order, so that a step here equals a step there within float32 rounding:

- ``sgd(lr)``: ``p − lr·g`` (``optax.sgd``, no momentum);
- ``adam(lr)``: ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias correction);
- ``adafactor(lr)``: ``optax.adafactor`` at its defaults: factored row and
  column second moments for a parameter whose two largest dims are both at
  least 128, decay 1 − step^−0.8, eps 1e-30, the update clipped to RMS ≤ 1,
  the step scaled by max(RMS(param), 1e-3), no momentum.
  ``torch.optim.Adafactor`` has other semantics and is not used.

An :class:`Optimizer` holds ``init(params, layout=None) → state`` and
``apply(params, grads, state, layout=None) → state``; ``apply`` updates the
parameters in place (the JAX package returns new arrays: in place saves a
copy of every parameter). ``params`` and ``grads`` map names to tensors; the
state is a dict of tensors on the parameters' device and a host step count,
which ``torch.save`` can write and ``torch.load(weights_only=True)`` can read.

Sharded parameters (tensor parallelism): ``layout`` maps a parameter's name
to how this rank holds it (``parallel.sharding.LocalShard``, None for whole).
sgd and adam are elementwise and ignore it. adafactor does what
``optax.adafactor`` does on the global tensor under GSPMD: its factored dims
come from the global shape, its row and column means, the update's RMS and
the parameter's RMS are sums over the model group divided by global counts,
and its factored moments ``v_row`` / ``v_col`` are whole on every rank (they
are not 2-D, so they replicate, as the JAX package places them).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

Params = Mapping[str, torch.Tensor]
#: name → ``parallel.sharding.LocalShard`` (or None: whole); see the module docstring.
Layout = Mapping[str, object]


@dataclass(frozen=True)
class Optimizer:
    """``init(params, layout=None) → state``; ``apply(params, grads, state, layout=None) → state``,
    updating params in place."""

    name: str
    init: Callable[..., dict]
    apply: Callable[..., dict]


def _f32(value: float) -> float:
    """``value`` rounded to float32, as JAX computes a weakly typed scalar."""
    return float(np.float32(value))


def sgd(learning_rate: float) -> Optimizer:
    """``optax.sgd(learning_rate)``: p + (−lr)·g."""

    def init(params: Params, layout: Layout | None = None) -> dict:
        return {"count": 0}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict, layout: Layout | None = None) -> dict:
        for name, param in params.items():
            param.add_(grads[name] * -learning_rate)
        return {"count": state["count"] + 1}

    return Optimizer("sgd", init, apply)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam(learning_rate)`` with its defaults."""

    def init(params: Params, layout: Layout | None = None) -> dict:
        return {
            "count": 0,
            "mu": {name: torch.zeros_like(p) for name, p in params.items()},
            "nu": {name: torch.zeros_like(p) for name, p in params.items()},
        }

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict, layout: Layout | None = None) -> dict:
        count = state["count"] + 1
        correction1 = _f32(1.0 - np.float32(b1) ** np.float32(count))
        correction2 = _f32(1.0 - np.float32(b2) ** np.float32(count))
        for name, param in params.items():
            grad, mu, nu = grads[name], state["mu"][name], state["nu"][name]
            mu.copy_((1.0 - b1) * grad + b1 * mu)
            nu.copy_((1.0 - b2) * (grad * grad) + b2 * nu)
            update = (mu / correction1) / (torch.sqrt(nu / correction2) + eps)
            param.add_(update * -learning_rate)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}

    return Optimizer("adam", init, apply)


def factored_dims(shape: tuple[int, ...], min_dim_size_to_factor: int = 128) -> tuple[int, int] | None:
    """optax's choice: the two largest dims (second largest, largest), if both reach the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _global_sum(tensor: torch.Tensor, shard) -> torch.Tensor:
    """The sum of every element of the global tensor (over the model group for a shard)."""
    total = tensor.sum()
    if shard is not None:
        dist.all_reduce(total, group=shard.group)
    return total


def _whole_mean(tensor: torch.Tensor, dim: int, shard, global_shape: tuple[int, ...]) -> torch.Tensor:
    """The mean over ``dim`` of the global tensor, whole on every rank (its dims after ``dim`` shift down)."""
    if shard is None:
        return tensor.mean(dim=dim)
    if dim == shard.dim:
        total = tensor.sum(dim=dim)
        dist.all_reduce(total, group=shard.group)
        return total / global_shape[dim]
    kept = shard.dim - 1 if shard.dim > dim else shard.dim
    mean = tensor.mean(dim=dim)
    pieces = [torch.empty_like(mean) for _ in range(shard.parts)]
    dist.all_gather(pieces, mean.contiguous(), group=shard.group)
    return torch.cat(pieces, dim=kept)


def _local_part(whole: torch.Tensor, removed: int, shard) -> torch.Tensor:
    """This rank's part of a whole moment that dropped dim ``removed`` of the parameter."""
    if shard is None or shard.dim == removed:
        return whole
    kept = shard.dim - 1 if shard.dim > removed else shard.dim
    return whole.chunk(shard.parts, dim=kept)[shard.index]


def _without(shape: tuple[int, ...], dim: int) -> tuple[int, ...]:
    return shape[:dim] + shape[dim + 1 :]


def adafactor(
    learning_rate: float,
    *,
    min_dim_size_to_factor: int = 128,
    decay_rate: float = 0.8,
    eps: float = 1e-30,
    clipping_threshold: float = 1.0,
    min_param_scale: float = 1e-3,
) -> Optimizer:
    """``optax.adafactor(learning_rate)`` at its defaults (no momentum, no weight decay)."""

    def shape_of(name: str, param: torch.Tensor, layout: Layout | None) -> tuple[int, ...]:
        shard = None if layout is None else layout.get(name)
        return tuple(param.shape) if shard is None else shard.global_shape(param.shape)

    def init(params: Params, layout: Layout | None = None) -> dict:
        v_row, v_col, v = {}, {}, {}
        for name, param in params.items():
            shape = shape_of(name, param, layout)
            dims = factored_dims(shape, min_dim_size_to_factor)
            if dims is None:
                v[name] = torch.zeros_like(param)
            else:
                d1, d0 = dims
                v_row[name] = param.new_zeros(_without(shape, d0))
                v_col[name] = param.new_zeros(_without(shape, d1))
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict, layout: Layout | None = None) -> dict:
        step = state["count"]
        decay = np.float32(1.0) - np.float32(step + 1) ** np.float32(-decay_rate)
        keep, take = _f32(decay), _f32(np.float32(1.0) - decay)
        for name, param in params.items():
            shard = None if layout is None else layout.get(name)
            shape = shape_of(name, param, layout)
            grad = grads[name]
            grad_sq = grad * grad + eps
            dims = factored_dims(shape, min_dim_size_to_factor)
            if dims is None:
                v = state["v"][name]
                v.copy_(keep * v + take * grad_sq)
                update = grad * v**-0.5
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][name], state["v_col"][name]
                v_row.copy_(keep * v_row + take * _whole_mean(grad_sq, d0, shard, shape))
                v_col.copy_(keep * v_col + take * _whole_mean(grad_sq, d1, shard, shape))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                row_factor = _local_part(row_factor, d0, shard)
                col_factor = _local_part(v_col**-0.5, d1, shard)
                update = grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            count = math.prod(shape)
            if shard is None:
                rms = torch.sqrt(torch.mean(update * update))
                param_rms = torch.sqrt(torch.mean(param * param))
            else:
                rms = torch.sqrt(_global_sum(update * update, shard) / count)
                param_rms = torch.sqrt(_global_sum(param * param, shard) / count)
            update = update / torch.clamp(rms / clipping_threshold, min=1.0)
            update = update * learning_rate
            update = update * torch.clamp(param_rms, min=min_param_scale)
            param.sub_(update)
        return {"count": step + 1, "v_row": state["v_row"], "v_col": state["v_col"], "v": state["v"]}

    return Optimizer("adafactor", init, apply)


__all__ = ["Optimizer", "adafactor", "adam", "factored_dims", "sgd"]
