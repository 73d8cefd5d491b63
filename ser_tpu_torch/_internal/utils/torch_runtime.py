"""Process-level device check of the CLI.

Counterpart of ``ser_tpu/_internal/utils/jax_runtime.py::honor_platform_env``,
which re-applies ``JAX_PLATFORMS`` before JAX picks a backend. The port's
selector is ``SER_TORCH_DEVICE``: the CLI resolves it once, first, so that a
process with no CUDA card and no request for the CPU stops before any work
with the runtime policy's ``RuntimeDependencyError`` (naming
``SER_TORCH_DEVICE=cpu``), and never falls back to the CPU by itself.
``ensure_compilation_cache`` has no counterpart: there is no XLA cache, and
the kernels' builds are cached under ``build/torch_kernels/`` by
``ops/kernel_build.py``.
"""

from __future__ import annotations

import os

import torch

from ser_tpu_torch._internal.config.schema import TorchRuntimeConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device


def honor_platform_env() -> torch.device:
    """The device ``SER_TORCH_DEVICE`` names (default ``auto``: the card); raises if it is absent."""
    request = os.environ.get("SER_TORCH_DEVICE", "").strip() or TorchRuntimeConfig().device
    return resolve_device(request)


__all__ = ["honor_platform_env"]
