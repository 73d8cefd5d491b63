"""Runtime profile catalog of the PyTorch port, held as Python data.

Counterpart of ``ser_tpu/profiles.py`` + ``ser_tpu/profile_defs.yaml``. The
port reads no YAML: the four entries (``fast``, ``medium``, ``accurate``,
``accurate-research``) are written out here with the same ``backend_id``,
default model id, runtime and transcription defaults as the JAX catalog
(``profile_defs.yaml``), so artifacts trained by either package load in the
other. The catalog's ``feature_runtime_defaults`` are not read at run time,
in either package: the runtime policy resolves the device and dtype
(``_internal/repr/runtime_policy.py``), so the fast profile, whose entry says
``device: cpu``, runs on the card like the others.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Literal

type ProfileName = Literal["fast", "medium", "accurate", "accurate-research"]

PROFILE_NAMES: tuple[ProfileName, ...] = ("fast", "medium", "accurate", "accurate-research")

#: Precedence when several profile flags are on: accurate-research > accurate
#: > medium > fast (as ``ser_tpu.profiles.PROFILE_PRECEDENCE``).
PROFILE_PRECEDENCE: tuple[ProfileName, ...] = ("accurate-research", "accurate", "medium", "fast")



@dataclass(frozen=True)
class ProfileRuntimeDefaults:
    """Execution budgets and postprocessing defaults for one profile.

    The boundaries' retry policy reads the budgets (``_internal/runtime/
    policy.py``); the windowed profiles read the pooling and postprocessing
    fields.
    """

    timeout_seconds: float
    max_timeout_retries: int
    max_transient_retries: int
    retry_backoff_seconds: float
    pool_window_size_seconds: float
    pool_window_stride_seconds: float
    post_smoothing_window_frames: int
    post_hysteresis_enter_confidence: float
    post_hysteresis_exit_confidence: float
    post_min_segment_duration_seconds: float
    process_isolation: bool


@dataclass(frozen=True)
class ProfileTranscriptionDefaults:
    """Default transcription backend selection for one profile."""

    backend_id: str
    model_name: str
    use_demucs: bool
    use_vad: bool


@dataclass(frozen=True)
class ProfileSpec:
    """One catalog entry: the fields the port reads.

    ``required_modules`` are the Python packages the profile's backend
    imports (the runtime registry reports a missing one); ``runtime_env``
    maps each runtime knob to its ``SER_<PROFILE>_<KNOB>`` variable.
    """

    name: ProfileName
    backend_id: str
    default_model_id: str | None
    runtime_defaults: ProfileRuntimeDefaults
    transcription_defaults: ProfileTranscriptionDefaults
    required_modules: tuple[str, ...] = ("torch",)

    @property
    def runtime_env(self) -> dict[str, str]:
        prefix = "SER_" + self.name.upper().replace("-", "_")
        return {knob.name: f"{prefix}_{knob.name.upper()}" for knob in fields(ProfileRuntimeDefaults)}


#: The postprocessing defaults every profile shares (``_shared_postproc``).
_SHARED_POSTPROCESSING = {
    "pool_window_size_seconds": 1.0,
    "pool_window_stride_seconds": 1.0,
    "post_smoothing_window_frames": 3,
    "post_hysteresis_enter_confidence": 0.60,
    "post_hysteresis_exit_confidence": 0.45,
    "post_min_segment_duration_seconds": 0.40,
}

_CATALOG: dict[ProfileName, ProfileSpec] = {
    "fast": ProfileSpec(
        name="fast",
        backend_id="handcrafted",
        default_model_id=None,
        runtime_defaults=ProfileRuntimeDefaults(
            timeout_seconds=0.0,
            max_timeout_retries=0,
            max_transient_retries=0,
            retry_backoff_seconds=0.0,
            **_SHARED_POSTPROCESSING,
            process_isolation=False,
        ),
        transcription_defaults=ProfileTranscriptionDefaults(
            backend_id="jax_whisper", model_name="distil-large-v3", use_demucs=False, use_vad=True
        ),
        required_modules=(),
    ),
    "medium": ProfileSpec(
        name="medium",
        backend_id="jax_xlsr",
        default_model_id="facebook/wav2vec2-xls-r-300m",
        runtime_defaults=ProfileRuntimeDefaults(
            timeout_seconds=60.0,
            max_timeout_retries=1,
            max_transient_retries=1,
            retry_backoff_seconds=0.25,
            **_SHARED_POSTPROCESSING,
            process_isolation=False,
        ),
        transcription_defaults=ProfileTranscriptionDefaults(
            backend_id="jax_whisper", model_name="turbo", use_demucs=True, use_vad=True
        ),
    ),
    "accurate": ProfileSpec(
        name="accurate",
        backend_id="jax_whisper_encoder",
        default_model_id="openai/whisper-large-v3",
        runtime_defaults=ProfileRuntimeDefaults(
            timeout_seconds=120.0,
            max_timeout_retries=0,
            max_transient_retries=1,
            retry_backoff_seconds=0.25,
            **_SHARED_POSTPROCESSING,
            process_isolation=False,
        ),
        transcription_defaults=ProfileTranscriptionDefaults(
            backend_id="jax_whisper", model_name="large", use_demucs=True, use_vad=True
        ),
    ),
    "accurate-research": ProfileSpec(
        name="accurate-research",
        backend_id="emotion2vec",
        default_model_id="iic/emotion2vec_plus_large",
        runtime_defaults=ProfileRuntimeDefaults(
            timeout_seconds=120.0,
            max_timeout_retries=0,
            max_transient_retries=1,
            retry_backoff_seconds=0.25,
            **_SHARED_POSTPROCESSING,
            process_isolation=False,
        ),
        transcription_defaults=ProfileTranscriptionDefaults(
            backend_id="jax_whisper", model_name="large", use_demucs=True, use_vad=True
        ),
    ),
}


def require_ported(profile: ProfileName) -> ProfileSpec:
    """The catalog entry of one profile; raises ``ValueError`` for an unknown name."""
    if profile not in _CATALOG:
        raise ValueError(f"Unknown profile {profile!r}. Expected one of {PROFILE_NAMES}.")
    return _CATALOG[profile]


def resolve_profile_name(
    *,
    medium_profile: bool,
    accurate_profile: bool,
    accurate_research_profile: bool,
) -> ProfileName:
    """Active profile name from runtime flags, by ``PROFILE_PRECEDENCE``."""
    active = {
        "accurate-research": accurate_research_profile,
        "accurate": accurate_profile,
        "medium": medium_profile,
        "fast": True,
    }
    for name in PROFILE_PRECEDENCE:
        if active[name]:
            return name
    return "fast"


__all__ = [
    "PROFILE_NAMES",
    "PROFILE_PRECEDENCE",
    "ProfileName",
    "ProfileRuntimeDefaults",
    "ProfileSpec",
    "ProfileTranscriptionDefaults",
    "require_ported",
    "resolve_profile_name",
]
