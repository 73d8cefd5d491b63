"""Sharding rules: where each tensor lives on the (data, model) mesh.

Counterpart of ``ser_tpu/parallel/sharding.py``. A placement is a tuple of
``torch.distributed.tensor`` placements, one per mesh axis (data, model), as
a ``DTensor`` spells it. The rules are the JAX package's: batches shard over
``data`` on their leading dim (dim 1 of a (K, B, ...) super-batch); encoder
parameters shard over ``model`` in Megatron's layout: the q/k/v and MLP-in
products column-parallel, the attention-out and MLP-out products
row-parallel; every tensor that is not 2-D (biases, LayerNorms, the conv
stem) and every other parameter replicates.

The transpose: a flax kernel is (in, out), an ``nn.Linear`` weight (out, in).
So flax's column-parallel ``P(None, "model")`` is ``Shard(0)`` of the weight
here, and its row-parallel ``P("model")`` is ``Shard(1)``.

Each process holds its shard as a plain tensor. :func:`shard_state_dict` cuts
a rank's shards out of a full state dict (or any nested dict of named
tensors, such as an optimizer state keyed by parameter name), and
:func:`gather_state_dict` puts the full tensors back together on every rank.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.placement_types import Placement, Replicate, Shard

from ser_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size

type Placements = tuple[Placement, Placement]

#: nn.Linear weights of the column-parallel (output rows cut) and row-parallel (input columns cut) products.
_COLUMN_PARALLEL = ("attn.q.weight", "attn.k.weight", "attn.v.weight", "mlp_in.weight")
_ROW_PARALLEL = ("attn.out.weight", "mlp_out.weight")


def replicated(mesh: DeviceMesh) -> Placements:
    """Fully replicated placement."""
    return (Replicate(), Replicate())


def batch_sharding(mesh: DeviceMesh, ndim: int) -> Placements:
    """Leading-axis data-parallel placement for an ndim-rank batch tensor."""
    return (Shard(0), Replicate())


def stacked_batch_sharding(mesh: DeviceMesh, ndim: int) -> Placements:
    """Data-parallel placement on dim 1 of a (steps, batch, ...) super-batch."""
    return (Shard(1), Replicate())


def model_dim(name: str, ndim: int) -> int | None:
    """The dim of a 2-D encoder weight cut over the model axis (by name), else None."""
    if ndim != 2:
        return None
    dotted = "." + name
    if dotted.endswith(tuple("." + tag for tag in _COLUMN_PARALLEL)):
        return 0
    if dotted.endswith(tuple("." + tag for tag in _ROW_PARALLEL)):
        return 1
    return None


def _param_placement(name: str, value: torch.Tensor) -> Placements:
    dim = model_dim(name, value.ndim)
    return (Replicate(), Replicate()) if dim is None else (Replicate(), Shard(dim))


def _map_named(fn, tree, prefix: str = ""):
    """Applies ``fn(name, tensor)`` to every tensor of a nested mapping; the name is the innermost key."""
    if isinstance(tree, Mapping):
        return {key: _map_named(fn, value, str(key)) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(prefix, tree)
    return tree


def encoder_param_sharding(mesh: DeviceMesh, params) -> dict:
    """The placement of every tensor of a (nested) mapping of named encoder tensors."""
    return _map_named(_param_placement, params)


@dataclass(frozen=True)
class LocalShard:
    """This rank's part of a tensor cut into ``parts`` equal pieces along ``dim`` over ``group``."""

    dim: int
    parts: int
    index: int
    group: dist.ProcessGroup

    def global_shape(self, local_shape) -> tuple[int, ...]:
        shape = list(local_shape)
        shape[self.dim] *= self.parts
        return tuple(shape)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        if full.shape[self.dim] % self.parts:
            raise ValueError(
                f"A dim of {full.shape[self.dim]} cannot be cut into {self.parts} equal shards."
            )
        return full.chunk(self.parts, dim=self.dim)[self.index].contiguous().clone()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        pieces = [torch.empty_like(local) for _ in range(self.parts)]
        dist.all_gather(pieces, local.contiguous(), group=self.group)
        return torch.cat(pieces, dim=self.dim)


def model_group(mesh: DeviceMesh | None) -> dist.ProcessGroup | None:
    """The model axis's group, or None where the axis has one rank (no collective to issue)."""
    if mesh is None or axis_size(mesh, MODEL_AXIS) == 1:
        return None
    return mesh.get_group(MODEL_AXIS)


def data_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    return mesh.get_group(DATA_AXIS)


def local_shard(mesh: DeviceMesh | None, name: str, ndim: int) -> LocalShard | None:
    """How this rank holds the tensor ``name`` (None: whole)."""
    group = model_group(mesh)
    dim = model_dim(name, ndim)
    if group is None or dim is None:
        return None
    return LocalShard(dim, axis_size(mesh, MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), group)


def shard_layout(mesh: DeviceMesh | None, params: Mapping[str, torch.Tensor]) -> dict[str, LocalShard | None]:
    """:func:`local_shard` of every named tensor (the optimizer's view of the placements)."""
    return {name: local_shard(mesh, name, value.ndim) for name, value in params.items()}


def shard_state_dict(mesh: DeviceMesh | None, state):
    """This rank's shards of a (nested) mapping of full named tensors; whole tensors pass through."""

    def cut(name: str, value: torch.Tensor) -> torch.Tensor:
        shard = local_shard(mesh, name, value.ndim)
        return value if shard is None else shard.cut(value)

    return _map_named(cut, state)


def gather_state_dict(mesh: DeviceMesh | None, state):
    """The full tensors of a (nested) mapping of this rank's shards, on every rank of the model axis."""

    def gather(name: str, value: torch.Tensor) -> torch.Tensor:
        shard = local_shard(mesh, name, value.ndim)
        return value if shard is None else shard.gather(value)

    return _map_named(gather, state)


def data_slice(mesh: DeviceMesh, tensor: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of a global batch along ``dim``; the data axis must divide it."""
    parts = axis_size(mesh, DATA_AXIS)
    if tensor.shape[dim] % parts:
        raise ValueError(
            f"Batch of {tensor.shape[dim]} is not divisible by the mesh data axis ({parts}); "
            "set SER_MESH_DATA_AXIS_SIZE/SER_MESH_MODEL_AXIS_SIZE to reshape."
        )
    return tensor.chunk(parts, dim=dim)[mesh.get_local_rank(DATA_AXIS)]


__all__ = [
    "LocalShard",
    "batch_sharding",
    "data_group",
    "data_slice",
    "encoder_param_sharding",
    "gather_state_dict",
    "local_shard",
    "model_dim",
    "model_group",
    "replicated",
    "shard_layout",
    "shard_state_dict",
    "stacked_batch_sharding",
]
