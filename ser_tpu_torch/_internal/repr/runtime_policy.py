"""Torch device and dtype resolution for one feature backend.

Counterpart of ``ser_tpu/_internal/repr/runtime_policy.py`` with one
deliberate difference: the port never falls back to the CPU by itself.
``"auto"`` (and ``"cuda"``/``"gpu"``) means the CUDA card and raises
``RuntimeDependencyError`` when there is none; the CPU runs only when asked
for by name (``SER_TORCH_DEVICE=cpu``). dtype: ``"auto"`` and ``"bfloat16"``
(``"float16"`` is clamped to it, as in the JAX package) give bf16 on the
card; the CPU always computes in float32 (``ser_tpu/_internal/repr/
encoders.py``). ``"int8"``, and ``"float32"`` on the card, are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ser_tpu_torch._internal.config.schema import TorchRuntimeConfig
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError

_ACCELERATOR_REQUESTS = ("", "auto", "cuda", "gpu", "accelerator")
_BF16_REQUESTS = ("auto", "", "bfloat16", "bf16", "float16", "fp16", "half")
_F32_REQUESTS = ("float32", "fp32", "f32")


@dataclass(frozen=True)
class ResolvedFeatureRuntime:
    """Final device/dtype selection for one backend."""

    backend_id: str
    device: torch.device
    dtype: str  # "float32" | "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def resolve_device(request: str) -> torch.device:
    """The torch device for one ``SER_TORCH_DEVICE`` value; raises if it is absent."""
    request = request.strip().lower()
    if request == "cpu":
        return torch.device("cpu")
    if request in _ACCELERATOR_REQUESTS or request.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeDependencyError(
                f"Torch device {request or 'auto'!r} needs a CUDA device and none is "
                "available. Set SER_TORCH_DEVICE=cpu to run on the CPU."
            )
        return torch.device("cuda" if request in _ACCELERATOR_REQUESTS else request)
    raise ValueError(f"Unknown torch device {request!r}; expected auto, cuda[:N] or cpu.")


def resolve_feature_runtime(
    backend_id: str, *, torch_runtime: TorchRuntimeConfig | None = None
) -> ResolvedFeatureRuntime:
    """Resolves device and dtype for one backend from the torch runtime settings."""
    runtime = torch_runtime if torch_runtime is not None else TorchRuntimeConfig()
    device = resolve_device(runtime.device)
    dtype_request = runtime.dtype.strip().lower()
    if dtype_request in ("int8", "w8a8"):
        raise NotImplementedError(
            "dtype int8 (W8A8 projections) is not ported to ser_tpu_torch yet; see ROADMAP.md."
        )
    if dtype_request not in _BF16_REQUESTS + _F32_REQUESTS:
        raise ValueError(f"Unknown torch dtype {runtime.dtype!r}.")
    on_card = device.type == "cuda"
    if on_card and dtype_request in _F32_REQUESTS:
        raise NotImplementedError(
            "dtype float32 on the CUDA card is not ported to ser_tpu_torch yet (kernel K2 "
            "takes bf16); see ROADMAP.md. Use SER_TORCH_DTYPE=auto, or SER_TORCH_DEVICE=cpu."
        )
    dtype = "bfloat16" if on_card else "float32"
    return ResolvedFeatureRuntime(backend_id=backend_id.strip().lower(), device=device, dtype=dtype)


__all__ = ["ResolvedFeatureRuntime", "resolve_device", "resolve_feature_runtime"]
