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

On a mesh the file holds the full tensors: :func:`save_train_state` gathers
every sharded tensor over the model axis, rank 0 writes, and the other ranks
wait at a barrier; :func:`restore_train_state` cuts each rank's shards out of
the file by the placement rules (``parallel.sharding``). A checkpoint written
at one mesh shape therefore restores at another, as the JAX package's
template-guided restore does.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env
from ser_tpu_torch.parallel.sharding import gather_state_dict, shard_state_dict

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
    mesh: DeviceMesh | None = None,
) -> str:
    """Persists one training-trajectory checkpoint (crash-safe overwrite); returns its path.

    With a ``mesh`` every rank calls it: the shards are gathered, rank 0
    writes, and every rank returns once the file is committed (or raises
    if rank 0 could not write it).
    """
    target = Path(path).absolute()
    encoder_params = _detached(encoder_params)
    if mesh is None:
        _write(target, encoder_params, _detached(head_params), opt_state, step)
        return str(target)
    encoder_params = gather_state_dict(mesh, encoder_params)
    opt_state = gather_state_dict(mesh, opt_state)
    _on_rank_zero(lambda: _write(target, encoder_params, _detached(head_params), opt_state, step))
    return str(target)


def _on_rank_zero(action) -> None:
    """Runs ``action`` on rank 0 while the other ranks wait; its error is raised on every rank."""
    outcome: list[tuple[bool, str] | None] = [None]
    if dist.get_rank() == 0:
        try:
            action()
        except Exception as err:  # noqa: BLE001 - re-raised on every rank below
            outcome = [(isinstance(err, FileNotFoundError), f"{type(err).__name__}: {err}")]
    dist.broadcast_object_list(outcome, src=0)
    if outcome[0] is not None:
        missing, message = outcome[0]
        raise (FileNotFoundError if missing else RuntimeError)(f"Checkpoint I/O failed on rank 0: {message}")


def _write(target: Path, encoder_params, head_params, opt_state, step: int) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "format": FORMAT,
        "encoder_params": encoder_params,
        "head_params": head_params,
        "opt_state": opt_state,
        "step": int(step),
    }
    if not target.exists():
        _commit(state, target)
        return
    staging = target.with_name(target.name + ".staging")
    _commit(state, staging)
    # The new checkpoint is committed; now the old one may go.
    target.unlink()
    staging.rename(target)


def restore_train_state(
    path: str | Path, *, map_location: torch.device | str | None = None, mesh: DeviceMesh | None = None
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor], Any, int]:
    """Restores ``(encoder_params, head_params, opt_state, step)``, tensors on ``map_location``.

    Falls back to a committed ``.staging`` sibling when the file is missing
    (the crash window of an interrupted overwrite). With a ``mesh``, the
    encoder parameters and the optimizer state are this rank's shards, cut
    from the file's full tensors whatever mesh wrote it.

    ``map_location`` None is the mesh's own device (this rank's card, or the
    CPU on a gloo mesh), as the JAX package restores onto its mesh; with no
    mesh, the device ``SER_TORCH_DEVICE`` names (the card, the CPU only when
    asked for; with neither, it raises).
    """
    if map_location is None:
        map_location = _mesh_device(mesh) if mesh is not None else honor_platform_env()
    target = Path(path).absolute()
    if mesh is None:
        _recover(target)
        state = _load(target, map_location)
        return state["encoder_params"], state["head_params"], state["opt_state"], int(state["step"])
    # Every rank reads the file; none may look before rank 0 has recovered it.
    _on_rank_zero(lambda: _recover(target))
    state = _load(target, "cpu")
    encoder_params = shard_state_dict(mesh, state["encoder_params"])
    opt_state = shard_state_dict(mesh, state["opt_state"])
    return (
        _moved(encoder_params, map_location),
        _moved(state["head_params"], map_location),
        _moved(opt_state, map_location),
        int(state["step"]),
    )


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: the current card (``init_group`` set it), or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _load(target: Path, map_location) -> dict:
    state = torch.load(target, map_location=map_location, weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{target} is not a {FORMAT} checkpoint.")
    return state


def _moved(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, Mapping):
        return {key: _moved(value, device) for key, value in tree.items()}
    return tree


def _recover(target: Path) -> None:
    """Takes a committed ``.staging`` copy's name back when the file itself is missing."""
    if not target.exists():
        staging = target.with_name(target.name + ".staging")
        if not staging.exists():
            raise FileNotFoundError(f"Checkpoint not found: {target}")
        logger.warning("Checkpoint %s missing; recovering committed staging copy.", target)
        staging.rename(target)


__all__ = ["FORMAT", "restore_train_state", "save_train_state"]
