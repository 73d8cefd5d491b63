"""Multi-process execution: the device mesh, sharding rules, the train step and its checkpoints.

Counterpart of ``ser_tpu/parallel``. The mesh and sharding rules are
imported eagerly, as in the JAX package; the train-step factories, the
checkpoint functions and batch inference are exposed lazily (PEP 562), since
they pull in the encoder stack.
"""

from ser_tpu_torch.parallel.mesh import build_mesh, mesh_shape_for
from ser_tpu_torch.parallel.sharding import (
    batch_sharding,
    encoder_param_sharding,
    replicated,
)

_LAZY = {
    "infer_many": "batch_inference",
    "make_sharded_train_loop": "train_step",
    "make_sharded_train_step": "train_step",
    "place_optimizer_state": "train_step",
    "restore_train_state": "checkpoint",
    "save_train_state": "checkpoint",
}

__all__ = sorted(
    [*_LAZY, "batch_sharding", "build_mesh", "encoder_param_sharding", "mesh_shape_for", "replicated"]
)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"ser_tpu_torch.parallel.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
