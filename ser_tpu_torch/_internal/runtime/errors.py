"""Inference errors of the port's profile boundary.

Counterpart of the error kinds in ``ser_tpu/_internal/runtime/errors.py`` that
the accurate path raises. The retry ladder's kinds (timeout, transient) wait
for the slice that ports the retry policy (``ROADMAP.md``).
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


__all__ = [
    "InferenceError",
    "ModelLoadError",
    "ModelUnavailableError",
    "RuntimeDependencyError",
    "UnsupportedProfileError",
]
