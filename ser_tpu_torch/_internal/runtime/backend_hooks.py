"""Backend hook construction: {backend_id → inference callable}.

Counterpart of ``ser_tpu/_internal/runtime/backend_hooks.py``: a hook exists
for a profile whose enable flag is on (the fast profile's always is) and, for
a restricted backend (emotion2vec), whose license gate opens
(``restricted_backends.ensure_backend_access``). A gated profile gets no
hook, so the pipeline refuses it with ``UnsupportedProfileError``, as in the
JAX package. The fast hook runs the fast boundary; the others the windowed
boundary with mean+std pooling.
"""

from __future__ import annotations

import functools
from collections.abc import Callable

from ser_tpu_torch._internal.config.artifact_naming import profile_artifact_file_name
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.encoders import build_encoder_backend
from ser_tpu_torch._internal.runtime import restricted_backends
from ser_tpu_torch._internal.runtime.fast_boundary import run_fast_inference
from ser_tpu_torch._internal.runtime.profile_boundary import (
    ProfileBoundarySpec,
    run_profile_inference,
)
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.profiles import PROFILE_NAMES, ProfileName, require_ported
from ser_tpu_torch.runtime.contracts import InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult

logger = get_logger(__name__)

type BackendHook = Callable[[InferenceRequest], InferenceResult]


def _profile_enabled(profile: ProfileName, settings: AppConfig) -> bool:
    flags = settings.runtime_flags
    return {
        "fast": True,
        "medium": flags.medium_profile,
        "accurate": flags.accurate_profile,
        "accurate-research": flags.accurate_research_profile,
    }[profile]


def build_profile_spec(profile: ProfileName, settings: AppConfig) -> ProfileBoundarySpec:
    """The boundary spec for one windowed profile."""
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
    """The hooks of the enabled profiles whose gates open."""
    hooks: dict[str, BackendHook] = {}
    for profile in PROFILE_NAMES:
        if not _profile_enabled(profile, settings):
            continue
        backend_id = require_ported(profile).backend_id
        try:
            restricted_backends.ensure_backend_access(backend_id, settings=settings)
        except restricted_backends.RestrictedBackendError as err:
            logger.debug("Restricted backend %s gated: %s", backend_id, err)
            continue
        if profile == "fast":
            hooks[backend_id] = functools.partial(run_fast_inference, settings=settings)
        else:
            spec = build_profile_spec(profile, settings)
            hooks[backend_id] = functools.partial(run_profile_inference, spec=spec, settings=settings)
    return hooks


__all__ = ["BackendHook", "build_backend_hooks", "build_profile_spec"]
