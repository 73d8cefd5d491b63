"""Masked uncertainty-weighted multitask objective.

Counterpart of ``ser_tpu/models/multitask_loss.py``: per-task losses are
combined with learned homoscedastic-uncertainty weights
(``exp(-log_variance) * mean_loss + log_variance``), per-sample masks select
the samples whose target exists for that task, and the primary task's weight
is clamped from below so that auxiliary heads cannot drown it out. The
log-variances live in a param dict of float32 scalar tensors; masked means
are guarded by their counts, and a task with no targets contributes exactly
zero. :func:`validate_multitask_inputs` carries the eager error contract.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import torch

PRIMARY_TASK = "primary_emotion"


def normalize_task_names(tasks: Sequence[str]) -> tuple[str, ...]:
    """De-duplicated, stripped task names; rejects empties and dotted names."""
    normalized = tuple(dict.fromkeys(task.strip() for task in tasks if task.strip()))
    if not normalized:
        raise ValueError("At least one multitask objective is required.")
    if any("." in task for task in normalized):
        raise ValueError("Task names cannot contain '.'.")
    return normalized


def init_multitask_loss_params(tasks: Sequence[str], *, device: torch.device | str = "cpu") -> dict:
    """Zero-initialized log variances (weight 1.0) per task."""
    return {
        "log_variances": {
            task: torch.zeros((), dtype=torch.float32, device=device) for task in normalize_task_names(tasks)
        }
    }


def validate_multitask_inputs(params: dict, losses: Mapping[str, object], masks: Mapping[str, object]) -> None:
    """Eager contract check: at least one registered task has targets."""
    if not set(params["log_variances"]) & set(losses) & set(masks):
        raise ValueError("No available targets were supplied to the multitask loss.")


def multitask_loss(
    params: dict,
    losses: Mapping[str, torch.Tensor],
    masks: Mapping[str, torch.Tensor],
    *,
    primary_task: str = PRIMARY_TASK,
    minimum_primary_weight: float = 0.25,
) -> torch.Tensor:
    """Scalar combined loss over the tasks present in both mappings.

    ``losses``: per-task per-sample loss vectors (scalars promote to shape
    (1,)); ``masks``: per-task availability masks of the same shape (1 = the
    target exists).
    """
    if not 0.0 < minimum_primary_weight <= 1.0:
        raise ValueError("minimum_primary_weight must be within (0, 1].")
    total: torch.Tensor | None = None
    for task, log_variance in params["log_variances"].items():
        if task not in losses or task not in masks:
            continue
        task_losses = torch.atleast_1d(torch.as_tensor(losses[task], dtype=torch.float32))
        mask = torch.atleast_1d(torch.as_tensor(masks[task]))
        if mask.shape != task_losses.shape:
            raise ValueError(f"Loss and mask shapes differ for task {task!r}.")
        mask = mask.to(device=task_losses.device, dtype=torch.float32)
        count = torch.sum(mask)
        mean_loss = torch.sum(task_losses * mask) / torch.clamp(count, min=1.0)
        weight = torch.exp(-log_variance)
        if task == primary_task:
            weight = torch.clamp(weight, min=minimum_primary_weight)
        contribution = weight * mean_loss + log_variance
        term = torch.where(count > 0, contribution, torch.zeros_like(contribution))
        total = term if total is None else total + term
    if total is None:
        device = next(iter(params["log_variances"].values())).device
        return torch.zeros((), dtype=torch.float32, device=device)
    return total


__all__ = [
    "PRIMARY_TASK",
    "init_multitask_loss_params",
    "multitask_loss",
    "normalize_task_names",
    "validate_multitask_inputs",
]
