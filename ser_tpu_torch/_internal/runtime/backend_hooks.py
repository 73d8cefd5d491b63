"""Backend hook construction: {backend_id → inference callable}.

Counterpart of ``ser_tpu/_internal/runtime/backend_hooks.py`` for the ported
profiles: a hook exists for a profile whose enable flag is on.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.encoders import build_encoder_backend
from ser_tpu_torch._internal.runtime.profile_boundary import (
    ProfileBoundarySpec,
    run_profile_inference,
)
from ser_tpu_torch.profiles import PORTED_PROFILES, ProfileName, require_ported
from ser_tpu_torch.runtime.contracts import InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult

type BackendHook = Callable[[InferenceRequest], InferenceResult]


def _profile_enabled(profile: ProfileName, settings: AppConfig) -> bool:
    flags = settings.runtime_flags
    return {"medium": flags.medium_profile, "accurate": flags.accurate_profile}.get(profile, False)


def build_profile_spec(profile: ProfileName, settings: AppConfig) -> ProfileBoundarySpec:
    """The boundary spec for one ported windowed profile."""
    catalog_spec = require_ported(profile)
    model_id = settings.profile_model_id(profile)
    return ProfileBoundarySpec(
        profile=profile,
        backend_id=catalog_spec.backend_id,
        model_id=model_id,
        backend_factory=functools.partial(build_encoder_backend, profile),
        artifact_file_name=profile_artifact_file_name(profile=profile, model_id=model_id),
    )


def build_backend_hooks(settings: AppConfig) -> dict[str, BackendHook]:
    """The hooks of the enabled, ported profiles."""
    hooks: dict[str, BackendHook] = {}
    for profile in PORTED_PROFILES:
        if not _profile_enabled(profile, settings):
            continue
        spec = build_profile_spec(profile, settings)
        hooks[spec.backend_id] = functools.partial(run_profile_inference, spec=spec, settings=settings)
    return hooks


__all__ = ["BackendHook", "build_backend_hooks", "build_profile_spec"]
