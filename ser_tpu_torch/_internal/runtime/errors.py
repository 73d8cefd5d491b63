"""Inference errors of the port's profile boundary and its worker processes.

Counterpart of ``ser_tpu/_internal/runtime/errors.py``: the six error kinds
and their wire names, by which a spawned worker's error crosses back to the
parent typed (``error_kind``, ``rehydrate_error``). The retry policy
(``policy.py``) retries the timeout and transient kinds, each from its own
budget.
"""

from __future__ import annotations


class InferenceError(RuntimeError):
    """Base class for profile inference failures."""

    def __init__(self, message: str, *, profile: str | None = None) -> None:
        super().__init__(message)
        self.profile = profile


class ModelUnavailableError(InferenceError):
    """No trained artifact is available for the requested profile/model."""


class RuntimeDependencyError(InferenceError):
    """A required runtime dependency (device, weights) is missing."""


class ModelLoadError(InferenceError):
    """The artifact exists but could not be loaded or failed compat checks."""


class UnsupportedProfileError(InferenceError):
    """The requested profile has no backend in this configuration (not enabled)."""


class InferenceTimeoutError(InferenceError):
    """The compute phase exceeded its per-attempt timeout budget."""


class TransientInferenceError(InferenceError):
    """A retryable failure; ``hard_oom`` marks a device OOM the same allocation would hit again."""

    def __init__(self, message: str, *, profile: str | None = None, hard_oom: bool = False) -> None:
        super().__init__(message, profile=profile)
        self.hard_oom = hard_oom


class InferenceExecutionError(InferenceError):
    """A non-retryable execution failure."""


#: Wire-stable names used across worker process boundaries (the JAX package's).
_ERROR_KINDS: dict[str, type[InferenceError]] = {
    "model_unavailable": ModelUnavailableError,
    "runtime_dependency": RuntimeDependencyError,
    "model_load": ModelLoadError,
    "timeout": InferenceTimeoutError,
    "transient": TransientInferenceError,
    "execution": InferenceExecutionError,
}
_KIND_BY_TYPE = {cls: kind for kind, cls in _ERROR_KINDS.items()}


def error_kind(error: BaseException) -> str:
    """Stable kind string for one error instance (default: execution)."""
    for cls in type(error).__mro__:
        if cls in _KIND_BY_TYPE:
            return _KIND_BY_TYPE[cls]
    return "execution"


def rehydrate_error(kind: str, message: str, *, profile: str | None = None) -> InferenceError:
    """Rebuilds a typed error from its wire form (worker → parent)."""
    return _ERROR_KINDS.get(kind, InferenceExecutionError)(message, profile=profile)


__all__ = [
    "InferenceError",
    "InferenceExecutionError",
    "InferenceTimeoutError",
    "ModelLoadError",
    "ModelUnavailableError",
    "RuntimeDependencyError",
    "TransientInferenceError",
    "UnsupportedProfileError",
    "error_kind",
    "rehydrate_error",
]
