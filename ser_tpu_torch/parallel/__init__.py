"""Training execution: the train step, its loop, optimizers and checkpoints.

Counterpart of ``ser_tpu/parallel``, on one device. The train-step factories
and checkpoint functions are exposed lazily (PEP 562), as in the JAX package.
"""

_LAZY = {
    "make_sharded_train_loop": "train_step",
    "make_sharded_train_step": "train_step",
    "place_optimizer_state": "train_step",
    "restore_train_state": "checkpoint",
    "save_train_state": "checkpoint",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(f"ser_tpu_torch.parallel.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
