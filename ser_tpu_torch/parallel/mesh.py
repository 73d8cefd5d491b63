"""The (data, model) device mesh over ``torch.distributed``.

Counterpart of ``ser_tpu/parallel/mesh.py``. The JAX package lays one
controller's devices out as a ``jax.sharding.Mesh``; here each process drives
one device, and the mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the world's ranks, laid out row-major as the JAX package reshapes its
devices: rank ``r`` sits at data index ``r // model`` and model index
``r % model``. The mesh is configured through ``MeshConfig``
(``SER_MESH_DATA_AXIS_SIZE`` / ``SER_MESH_MODEL_AXIS_SIZE``); an axis size of 0
means "absorb the remaining processes".

A process that has formed no group yet (one process, no ``SER_DIST_*``) gets
a 1×1 mesh over a world-size-1 group that :func:`build_mesh` forms itself
through an in-memory store, so a single-process caller needs no setup, as
with the JAX package's ``build_mesh`` on one device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ser_tpu_torch._internal.config.schema import MeshConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch.parallel.distributed import init_group

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape_for(n_devices: int, config: MeshConfig | None = None) -> tuple[int, int]:
    """Resolves (data, model) axis sizes for one device count."""
    config = config if config is not None else MeshConfig()
    data_cfg, model_cfg = config.data_axis_size, config.model_axis_size
    if data_cfg > 0 and model_cfg > 0:
        data, model = data_cfg, model_cfg
    elif model_cfg > 0:
        model = model_cfg
        if n_devices % model != 0:
            raise ValueError(
                f"model_axis_size {model} does not divide device count {n_devices}."
            )
        data = n_devices // model
    elif data_cfg > 0:
        # Either axis may absorb the remaining devices (docstring contract).
        data = data_cfg
        if n_devices % data != 0:
            raise ValueError(
                f"data_axis_size {data} does not divide device count {n_devices}."
            )
        model = n_devices // data
    else:
        data, model = n_devices, 1
    if data * model != n_devices:
        raise ValueError(
            f"Mesh {data}x{model} does not match device count {n_devices}."
        )
    return data, model


def build_mesh(config: MeshConfig | None = None, *, device_type: str | None = None) -> DeviceMesh:
    """Builds the ("data", "model") mesh over the world's ranks.

    ``device_type`` None resolves the device as every entry point does
    (``SER_TORCH_DEVICE``: the card unless it says ``cpu``; no card raises).
    """
    if device_type is None:
        device_type = resolve_device(os.environ.get("SER_TORCH_DEVICE", "auto")).type
    if not dist.is_initialized():
        mesh_shape_for(1, config)  # a mesh above 1x1 needs initialize_distributed first
        device = torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")
        init_group(device, store=dist.HashStore(), world_size=1, rank=0)
    data, model = mesh_shape_for(dist.get_world_size(), config)
    ranks = torch.arange(data * model, dtype=torch.int).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


__all__ = ["DATA_AXIS", "MODEL_AXIS", "axis_size", "build_mesh", "mesh_shape_for"]
