"""Train-state checkpoint and resume for the training loop.

Counterpart of ``ser_tpu/parallel/checkpoint.py``: one file holds the encoder
parameters, the head, the optimizer state and the step. The format is the
port's own, ``torch.save`` of a dict of tensors, ints and strings, read back
with ``torch.load(weights_only=True)``: orbax cannot be written without JAX
(a deliberate difference, ``ROADMAP.md`` Queue 3).

Overwrites are crash-safe as ``ser_tpu/_internal/models/orbax_io.py`` makes
them: the new state is committed to a ``<name>.staging`` sibling first (written
to ``<name>.staging.partial``, then renamed), and only then does the old file
go and the staging file take its name. A crash leaves the old checkpoint or a
committed staging copy, which :func:`restore_train_state` recovers.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import torch

logger = logging.getLogger(__name__)

FORMAT = "ser_tpu_torch.train_state/1"


def _detached(tensors: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {name: tensor.detach() for name, tensor in tensors.items()}


def _commit(state: dict, path: Path) -> None:
    partial = path.with_name(path.name + ".partial")
    torch.save(state, partial)
    os.replace(partial, path)


def save_train_state(
    path: str | Path,
    *,
    encoder_params: Mapping[str, torch.Tensor],
    head_params: Mapping[str, torch.Tensor],
    opt_state: dict,
    step: int,
) -> str:
    """Persists one training-trajectory checkpoint (crash-safe overwrite); returns its path."""
    target = Path(path).absolute()
    target.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "format": FORMAT,
        "encoder_params": _detached(encoder_params),
        "head_params": _detached(head_params),
        "opt_state": opt_state,
        "step": int(step),
    }
    if not target.exists():
        _commit(state, target)
        return str(target)
    staging = target.with_name(target.name + ".staging")
    _commit(state, staging)
    # The new checkpoint is committed; now the old one may go.
    target.unlink()
    staging.rename(target)
    return str(target)


def restore_train_state(
    path: str | Path, *, map_location: torch.device | str = "cpu"
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], Any, int]:
    """Restores ``(encoder_params, head_params, opt_state, step)``, tensors on ``map_location``.

    Falls back to a committed ``.staging`` sibling when the file is missing
    (the crash window of an interrupted overwrite).
    """
    target = Path(path).absolute()
    if not target.exists():
        staging = target.with_name(target.name + ".staging")
        if not staging.exists():
            raise FileNotFoundError(f"Checkpoint not found: {target}")
        logger.warning("Checkpoint %s missing; recovering committed staging copy.", target)
        staging.rename(target)
    state = torch.load(target, map_location=map_location, weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{target} is not a {FORMAT} checkpoint.")
    return state["encoder_params"], state["head_params"], state["opt_state"], int(state["step"])


__all__ = ["FORMAT", "restore_train_state", "save_train_state"]
