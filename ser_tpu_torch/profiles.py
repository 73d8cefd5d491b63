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
type TranscriptionBackendId = Literal["jax_whisper", "stable_whisper", "faster_whisper"]

PROFILE_NAMES: tuple[ProfileName, ...] = ("fast", "medium", "accurate", "accurate-research")

#: Precedence when several profile flags are on: accurate-research > accurate
#: > medium > fast (as ``ser_tpu.profiles.PROFILE_PRECEDENCE``).
PROFILE_PRECEDENCE: tuple[ProfileName, ...] = ("accurate-research", "accurate", "medium", "fast")


class ProfileCatalogError(ValueError):
    """Raised for a profile name the catalog does not hold."""


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

    backend_id: TranscriptionBackendId
    model_name: str
    use_demucs: bool
    use_vad: bool


@dataclass(frozen=True)
class ProfileModelSpec:
    """Foundation-model selection for one profile."""

    default_model_id: str | None
    env_var: str | None


@dataclass(frozen=True)
class ProfileFeatureRuntimeDefaults:
    """The catalog's device and dtype selectors; not read at run time (see above)."""

    device: str = "auto"
    dtype: str = "float32"


@dataclass(frozen=True)
class ProfileSpec:
    """One catalog entry, with the fields of ``ser_tpu.profiles.ProfileSpec``.

    ``required_modules`` are the Python packages the profile's backend
    imports (the runtime registry reports a missing one); ``runtime_env``
    maps each runtime knob to its ``SER_<PROFILE>_<KNOB>`` variable and
    ``transcription_env`` each transcription default to its ``WHISPER_*``
    variable.
    """

    name: ProfileName
    description: str
    backend_id: str
    required_modules: tuple[str, ...]
    enable_flag: str | None
    enabled_by_default: bool
    model: ProfileModelSpec
    feature_runtime_defaults: ProfileFeatureRuntimeDefaults
    transcription_defaults: ProfileTranscriptionDefaults
    runtime_defaults: ProfileRuntimeDefaults
    runtime_env: dict[str, str]
    transcription_env: dict[str, str]

    @property
    def default_model_id(self) -> str | None:
        return self.model.default_model_id


_TRANSCRIPTION_ENV: dict[str, str] = {
    "backend_id": "WHISPER_BACKEND",
    "model_name": "WHISPER_MODEL",
    "use_demucs": "WHISPER_DEMUCS",
    "use_vad": "WHISPER_VAD",
}

#: The postprocessing defaults every profile shares (``_shared_postproc``).
_SHARED_POSTPROCESSING = {
    "pool_window_size_seconds": 1.0,
    "pool_window_stride_seconds": 1.0,
    "post_smoothing_window_frames": 3,
    "post_hysteresis_enter_confidence": 0.60,
    "post_hysteresis_exit_confidence": 0.45,
    "post_min_segment_duration_seconds": 0.40,
}


def _entry(
    name: ProfileName,
    *,
    description: str,
    backend_id: str,
    required_modules: tuple[str, ...],
    default_model_id: str | None,
    feature_dtype: str,
    whisper_model: str,
    use_demucs: bool,
    timeout_seconds: float,
    max_timeout_retries: int,
    max_transient_retries: int,
    retry_backoff_seconds: float,
) -> ProfileSpec:
    """One entry, its variable names derived from the profile name as ``ser_tpu`` derives them."""
    prefix = "SER_" + name.upper().replace("-", "_")
    return ProfileSpec(
        name=name,
        description=description,
        backend_id=backend_id,
        required_modules=required_modules,
        enable_flag=None if name == "fast" else f"SER_ENABLE_{name.upper().replace('-', '_')}_PROFILE",
        enabled_by_default=name == "fast",
        model=ProfileModelSpec(
            default_model_id=default_model_id,
            env_var=None if default_model_id is None else f"{prefix}_MODEL_ID",
        ),
        feature_runtime_defaults=ProfileFeatureRuntimeDefaults(
            device="cpu" if name == "fast" else "auto", dtype=feature_dtype
        ),
        transcription_defaults=ProfileTranscriptionDefaults(
            backend_id="jax_whisper", model_name=whisper_model, use_demucs=use_demucs, use_vad=True
        ),
        runtime_defaults=ProfileRuntimeDefaults(
            timeout_seconds=timeout_seconds,
            max_timeout_retries=max_timeout_retries,
            max_transient_retries=max_transient_retries,
            retry_backoff_seconds=retry_backoff_seconds,
            **_SHARED_POSTPROCESSING,
            process_isolation=False,
        ),
        runtime_env={knob.name: f"{prefix}_{knob.name.upper()}" for knob in fields(ProfileRuntimeDefaults)},
        transcription_env=dict(_TRANSCRIPTION_ENV),
    )


_CATALOG: dict[ProfileName, ProfileSpec] = {
    "fast": _entry(
        "fast",
        description="CPU-capable handcrafted DSP pipeline (DSP features on the card).",
        backend_id="handcrafted",
        required_modules=(),
        default_model_id=None,
        feature_dtype="float32",
        whisper_model="distil-large-v3",
        use_demucs=False,
        timeout_seconds=0.0,
        max_timeout_retries=0,
        max_transient_retries=0,
        retry_backoff_seconds=0.0,
    ),
    "medium": _entry(
        "medium",
        description="SSL medium-latency pipeline (wav2vec2 XLS-R class encoder).",
        backend_id="jax_xlsr",
        required_modules=("torch",),
        default_model_id="facebook/wav2vec2-xls-r-300m",
        feature_dtype="float32",
        whisper_model="turbo",
        use_demucs=True,
        timeout_seconds=60.0,
        max_timeout_retries=1,
        max_transient_retries=1,
        retry_backoff_seconds=0.25,
    ),
    "accurate": _entry(
        "accurate",
        description="Highest-accuracy Whisper-encoder embeddings profile.",
        backend_id="jax_whisper_encoder",
        required_modules=("torch",),
        default_model_id="openai/whisper-large-v3",
        feature_dtype="bfloat16",
        whisper_model="large",
        use_demucs=True,
        timeout_seconds=120.0,
        max_timeout_retries=0,
        max_transient_retries=1,
        retry_backoff_seconds=0.25,
    ),
    "accurate-research": _entry(
        "accurate-research",
        description="Research-grade profile with restricted backend policy.",
        backend_id="emotion2vec",
        required_modules=("torch",),
        default_model_id="iic/emotion2vec_plus_large",
        feature_dtype="bfloat16",
        whisper_model="large",
        use_demucs=True,
        timeout_seconds=120.0,
        max_timeout_retries=0,
        max_transient_retries=1,
        retry_backoff_seconds=0.25,
    ),
}


def get_profile_catalog() -> dict[ProfileName, ProfileSpec]:
    """The catalog, in ``PROFILE_NAMES`` order."""
    return dict(_CATALOG)


def list_profile_names() -> tuple[ProfileName, ...]:
    """Returns all registered profile names in catalog order."""
    return PROFILE_NAMES


def require_ported(profile: ProfileName) -> ProfileSpec:
    """The catalog entry of one profile; raises ``ProfileCatalogError`` (a ``ValueError``) for an unknown name."""
    if profile not in _CATALOG:
        raise ProfileCatalogError(f"Unknown profile {profile!r}. Expected one of {PROFILE_NAMES}.")
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


type ProfileEnableFlag = Literal[
    "SER_ENABLE_MEDIUM_PROFILE",
    "SER_ENABLE_ACCURATE_PROFILE",
    "SER_ENABLE_ACCURATE_RESEARCH_PROFILE",
]

#: The catalog entry and model types under the names ``ser_tpu`` exports too.
ProfileCatalogEntry = ProfileSpec
ProfileModelDefinition = ProfileModelSpec


@dataclass(frozen=True)
class RuntimeProfile:
    """A profile's name and description."""

    name: ProfileName
    description: str


def available_profiles() -> dict[str, RuntimeProfile]:
    """Every profile's name and description, in catalog order."""
    return {name: RuntimeProfile(name=name, description=entry.description) for name, entry in _CATALOG.items()}


def resolve_profile(settings: object) -> RuntimeProfile:
    """The active profile of a settings object's ``runtime_flags``."""
    flags = getattr(settings, "runtime_flags", None)
    name = resolve_profile_name(
        medium_profile=bool(getattr(flags, "medium_profile", False)),
        accurate_profile=bool(getattr(flags, "accurate_profile", False)),
        accurate_research_profile=bool(getattr(flags, "accurate_research_profile", False)),
    )
    return available_profiles()[name]


__all__ = [
    "PROFILE_NAMES",
    "PROFILE_PRECEDENCE",
    "ProfileCatalogEntry",
    "ProfileCatalogError",
    "ProfileEnableFlag",
    "ProfileFeatureRuntimeDefaults",
    "ProfileModelDefinition",
    "ProfileModelSpec",
    "ProfileName",
    "ProfileRuntimeDefaults",
    "ProfileSpec",
    "ProfileTranscriptionDefaults",
    "RuntimeProfile",
    "TranscriptionBackendId",
    "available_profiles",
    "get_profile_catalog",
    "list_profile_names",
    "require_ported",
    "resolve_profile",
    "resolve_profile_name",
]
