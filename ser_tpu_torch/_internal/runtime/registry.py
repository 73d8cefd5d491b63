"""Profile → backend capability resolution.

Counterpart of ``ser_tpu/_internal/runtime/registry.py``: ``RuntimeCapability``
reports whether the catalog's ``required_modules`` import and whether the
profile's backend has a hook (``backend_hooks.build_backend_hooks`` builds
none for a profile that is not turned on or whose license gate is shut);
``ensure_profile_supported`` raises ``UnsupportedProfileError``. That class is
the one the pipeline raises (``_internal/runtime/errors.py``), re-exported
here, so the command runner maps either to exit code 2.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass, field

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError
from ser_tpu_torch.profiles import ProfileName, require_ported


@dataclass(frozen=True)
class RuntimeCapability:
    """Availability verdict for one profile in the current environment."""

    profile: ProfileName
    backend_id: str
    available: bool
    missing_modules: tuple[str, ...] = field(default_factory=tuple)
    message: str = ""


def _module_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def resolve_runtime_capability(
    profile: ProfileName,
    *,
    settings: AppConfig | None = None,
    available_hooks: frozenset[str] | None = None,
) -> RuntimeCapability:
    """Resolves availability for one profile from its modules and the hook registry.

    ``settings`` informs nothing here: the enable flags and the license gate
    act where the hooks are built, so an absent hook already reflects them.
    """
    spec = require_ported(profile)
    missing = tuple(m for m in spec.required_modules if not _module_available(m))
    if missing:
        return RuntimeCapability(
            profile=profile,
            backend_id=spec.backend_id,
            available=False,
            missing_modules=missing,
            message=f"Profile {profile!r} requires missing modules: {', '.join(missing)}.",
        )
    if available_hooks is not None and spec.backend_id not in available_hooks:
        return RuntimeCapability(
            profile=profile,
            backend_id=spec.backend_id,
            available=False,
            message=(
                f"Profile {profile!r} backend {spec.backend_id!r} has no registered "
                "hook (disabled flag, missing consent, or unavailable runtime)."
            ),
        )
    return RuntimeCapability(profile=profile, backend_id=spec.backend_id, available=True)


def ensure_profile_supported(capability: RuntimeCapability) -> None:
    """Raises ``UnsupportedProfileError`` when the capability is unavailable."""
    if not capability.available:
        raise UnsupportedProfileError(
            capability.message or f"Profile {capability.profile!r} unavailable.", profile=capability.profile
        )


__all__ = [
    "RuntimeCapability",
    "UnsupportedProfileError",
    "ensure_profile_supported",
    "resolve_runtime_capability",
]
