"""Ambient settings bootstrap: the process snapshot and its scoped overrides.

Counterpart of ``ser_tpu/_internal/config/bootstrap.py``: ``get_settings``
returns the active snapshot (a scoped override, else the ambient one, built on
first use), ``reload_settings`` re-captures the environment into the ambient
snapshot, and ``settings_override`` scopes one snapshot to the current context
(a ``ContextVar``, so concurrent workflows never see each other's). Built on
``settings_inputs.capture_settings_inputs`` and
``settings_builder.build_settings_from_inputs``; the variables and their
refusals are listed there.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping
from contextlib import contextmanager
from contextvars import ContextVar
from threading import Lock

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.config.settings_builder import build_settings_from_inputs
from ser_tpu_torch._internal.config.settings_inputs import SettingsInputError, capture_settings_inputs

_ambient_settings: AppConfig | None = None
_ambient_lock = Lock()
_scoped_settings: ContextVar[AppConfig | None] = ContextVar("ser_tpu_torch_settings", default=None)


def build_settings(env: Mapping[str, str] | None = None) -> AppConfig:
    """Builds one fresh settings snapshot from ``env`` (default: the process environment)."""
    return build_settings_from_inputs(capture_settings_inputs(dict(env) if env is not None else None))


def get_settings() -> AppConfig:
    """Returns the active settings snapshot (scoped override > ambient)."""
    scoped = _scoped_settings.get()
    if scoped is not None:
        return scoped
    global _ambient_settings
    if _ambient_settings is None:
        with _ambient_lock:
            if _ambient_settings is None:
                _ambient_settings = build_settings()
    return _ambient_settings


def reload_settings() -> AppConfig:
    """Rebuilds the ambient snapshot from the current environment and returns it."""
    global _ambient_settings
    with _ambient_lock:
        _ambient_settings = build_settings()
        return _ambient_settings


@contextmanager
def settings_override(settings: AppConfig) -> Iterator[AppConfig]:
    """Scopes one explicit settings snapshot to the current context."""
    token = _scoped_settings.set(settings)
    try:
        yield settings
    finally:
        _scoped_settings.reset(token)


__all__ = ["SettingsInputError", "build_settings", "get_settings", "reload_settings", "settings_override"]
