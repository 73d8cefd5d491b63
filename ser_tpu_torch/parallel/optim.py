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

An :class:`Optimizer` holds ``init(params) → state`` and
``apply(params, grads, state) → state``; ``apply`` updates the parameters in
place (the JAX package returns new arrays: in place saves a copy of every
parameter). ``params`` and ``grads`` map names to tensors; the state is a
dict of tensors on the parameters' device and a host step count, which
``torch.save`` can write and ``torch.load(weights_only=True)`` can read.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from dataclasses import dataclass

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class Optimizer:
    """``init(params) → state``; ``apply(params, grads, state) → state``, updating params in place."""

    name: str
    init: Callable[[Params], dict]
    apply: Callable[[Params, Params, dict], dict]


def _f32(value: float) -> float:
    """``value`` rounded to float32, as JAX computes a weakly typed scalar."""
    return float(np.float32(value))


def sgd(learning_rate: float) -> Optimizer:
    """``optax.sgd(learning_rate)``: p + (−lr)·g."""

    def init(params: Params) -> dict:
        return {"count": 0}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> dict:
        for name, param in params.items():
            param.add_(grads[name] * -learning_rate)
        return {"count": state["count"] + 1}

    return Optimizer("sgd", init, apply)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam(learning_rate)`` with its defaults."""

    def init(params: Params) -> dict:
        return {
            "count": 0,
            "mu": {name: torch.zeros_like(p) for name, p in params.items()},
            "nu": {name: torch.zeros_like(p) for name, p in params.items()},
        }

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> dict:
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

    def init(params: Params) -> dict:
        v_row, v_col, v = {}, {}, {}
        for name, param in params.items():
            dims = factored_dims(tuple(param.shape), min_dim_size_to_factor)
            if dims is None:
                v[name] = torch.zeros_like(param)
            else:
                d1, d0 = dims
                v_row[name] = torch.zeros_like(param.select(d0, 0))
                v_col[name] = torch.zeros_like(param.select(d1, 0))
        return {"count": 0, "v_row": v_row, "v_col": v_col, "v": v}

    @torch.no_grad()
    def apply(params: Params, grads: Params, state: dict) -> dict:
        step = state["count"]
        decay = np.float32(1.0) - np.float32(step + 1) ** np.float32(-decay_rate)
        keep, take = _f32(decay), _f32(np.float32(1.0) - decay)
        for name, param in params.items():
            grad = grads[name]
            grad_sq = grad * grad + eps
            dims = factored_dims(tuple(param.shape), min_dim_size_to_factor)
            if dims is None:
                v = state["v"][name]
                v.copy_(keep * v + take * grad_sq)
                update = grad * v**-0.5
            else:
                d1, d0 = dims
                v_row, v_col = state["v_row"][name], state["v_col"][name]
                v_row.copy_(keep * v_row + take * grad_sq.mean(dim=d0))
                v_col.copy_(keep * v_col + take * grad_sq.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                update = grad * row_factor.unsqueeze(d0) * (v_col**-0.5).unsqueeze(d1)
            rms = torch.sqrt(torch.mean(update * update))
            update = update / torch.clamp(rms / clipping_threshold, min=1.0)
            update = update * learning_rate
            update = update * torch.clamp(torch.sqrt(torch.mean(param * param)), min=min_param_scale)
            param.sub_(update)
        return {"count": step + 1, "v_row": state["v_row"], "v_col": state["v_col"], "v": state["v"]}

    return Optimizer("adafactor", init, apply)


__all__ = ["Optimizer", "adafactor", "adam", "factored_dims", "sgd"]
