"""Torch device and dtype resolution for one feature backend.

Counterpart of ``ser_tpu/_internal/repr/runtime_policy.py``: per-backend
supported dtypes and ``"auto"`` dtypes (``jax_xlsr`` and
``jax_whisper_encoder`` resolve ``"auto"`` to bf16 on the card), with one
deliberate difference: the port never falls back to the CPU by itself.
``"auto"`` (and ``"cuda"``/``"gpu"``) means the CUDA card and raises
``RuntimeDependencyError`` when there is none; the CPU runs only when asked
for by name (``SER_TORCH_DEVICE=cpu``). dtype on the card: ``"auto"`` gives the
backend's default, ``"bfloat16"`` bf16 (``"float16"`` is clamped to it, as in
the JAX package), ``"float32"`` float32 (kernel K2-f32 runs its attention); a
dtype the backend does not support is clamped to its first supported one, as
in the JAX package. The CPU always computes in float32
(``ser_tpu/_internal/repr/encoders.py``). ``"int8"`` is not ported yet and
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ser_tpu_torch._internal.config.schema import TorchRuntimeConfig
from ser_tpu_torch._internal.runtime.errors import RuntimeDependencyError

_ACCELERATOR_REQUESTS = ("", "auto", "cuda", "gpu", "accelerator")
_AUTO_REQUESTS = ("auto", "")
_BF16_REQUESTS = ("bfloat16", "bf16", "float16", "fp16", "half")
_F32_REQUESTS = ("float32", "fp32", "f32")

#: dtypes each backend computes in, the first being its fallback (the JAX
#: package's table, less int8, which is not ported).
_SUPPORTED_DTYPES: dict[str, tuple[str, ...]] = {
    "handcrafted": ("float32",),
    "jax_xlsr": ("float32", "bfloat16"),
    "jax_whisper_encoder": ("float32", "bfloat16"),
    "emotion2vec": ("float32", "bfloat16"),
}
#: What ``"auto"`` resolves to on the card, per backend (float32 elsewhere).
_DEFAULT_AUTO_DTYPE: dict[str, str] = {
    "handcrafted": "float32",
    "jax_xlsr": "bfloat16",
    "jax_whisper_encoder": "bfloat16",
    "emotion2vec": "bfloat16",
}


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
    backend_id = backend_id.strip().lower()
    runtime = torch_runtime if torch_runtime is not None else TorchRuntimeConfig()
    device = resolve_device(runtime.device)
    dtype_request = runtime.dtype.strip().lower()
    if dtype_request in ("int8", "w8a8"):
        raise NotImplementedError(
            "dtype int8 (W8A8 projections) is not ported to ser_tpu_torch yet; see ROADMAP.md."
        )
    if dtype_request in _AUTO_REQUESTS:
        dtype = _DEFAULT_AUTO_DTYPE.get(backend_id, "float32")
    elif dtype_request in _BF16_REQUESTS:
        dtype = "bfloat16"
    elif dtype_request in _F32_REQUESTS:
        dtype = "float32"
    else:
        raise ValueError(f"Unknown torch dtype {runtime.dtype!r}.")
    supported = _SUPPORTED_DTYPES.get(backend_id, ("float32", "bfloat16"))
    if dtype not in supported:
        dtype = supported[0]
    if device.type != "cuda":
        dtype = "float32"
    return ResolvedFeatureRuntime(backend_id=backend_id, device=device, dtype=dtype)


def refuse_float32_decode_on_card(device: torch.device | str) -> None:
    """Raises for a float32 Whisper decode on the CUDA card.

    The decode steps through kernels K3, K4 and K5, which take bf16 only; the
    float32 attention kernel K2-f32 serves the encoders, not the decode.
    """
    if torch.device(device).type == "cuda":
        raise NotImplementedError(
            "dtype float32 on the CUDA card is not ported for the Whisper decode: its step kernels "
            "K3, K4 and K5 take bf16 only; see ROADMAP.md. Use compute_dtype='bfloat16' "
            "(SER_TORCH_DTYPE=auto), or the CPU."
        )


__all__ = [
    "ResolvedFeatureRuntime",
    "refuse_float32_decode_on_card",
    "resolve_device",
    "resolve_feature_runtime",
]
