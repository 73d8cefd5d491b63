"""One-shot environment capture into a frozen inputs snapshot.

Counterpart of ``ser_tpu/_internal/config/settings_inputs.py``: the same
``SER_*`` / ``WHISPER_*`` variables, aliases and refusals, so one environment
configures both packages alike. The port's own: the device and dtype come from
``SER_TORCH_DEVICE`` and ``SER_TORCH_DTYPE`` (``SER_JAX_*`` are the JAX
package's). ``SER_DECODE_INT8`` is read where the transcription model is
built, ``SER_ALLOW_RANDOM_INIT`` / ``SER_RANDOM_INIT_SIZE`` where the weights
are resolved, ``SER_DEVICE_POOLING`` where the medium profile encodes,
``SER_FAST_DEVICE_FRAMING`` where the fast profile frames its clip, and
``SER_RESTRICTED_BACKENDS_CONSENT_FILE`` where consent is read, as in the JAX
package.
"""


from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

from ser_tpu_torch.profiles import PROFILE_NAMES, ProfileName, require_ported

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


class SettingsInputError(ValueError):
    """Raised when an environment variable holds an unparseable value."""


def read_env_str(env: dict[str, str], name: str) -> str | None:
    raw = env.get(name)
    if raw is None:
        return None
    stripped = raw.strip()
    return stripped or None


def read_env_bool(env: dict[str, str], name: str) -> bool | None:
    raw = read_env_str(env, name)
    if raw is None:
        return None
    lowered = raw.lower()
    if lowered in _TRUTHY:
        return True
    if lowered in _FALSY:
        return False
    raise SettingsInputError(f"Env var {name}={raw!r} is not a boolean.")


def read_env_int(env: dict[str, str], name: str) -> int | None:
    raw = read_env_str(env, name)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError as err:
        raise SettingsInputError(f"Env var {name}={raw!r} is not an integer.") from err


def read_env_float(env: dict[str, str], name: str) -> float | None:
    raw = read_env_str(env, name)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError as err:
        raise SettingsInputError(f"Env var {name}={raw!r} is not a float.") from err


def read_env_path(env: dict[str, str], name: str) -> Path | None:
    raw = read_env_str(env, name)
    return Path(raw).expanduser() if raw is not None else None


def _first(reader, env: dict[str, str], *names: str):
    """First non-None read across alias env names (listed first wins)."""
    for name in names:
        value = reader(env, name)
        if value is not None:
            return value
    return None


@dataclass(frozen=True)
class ProfileRuntimeOverrides:
    """Captured per-profile SER_<PROFILE>_* runtime knob overrides (partial)."""

    timeout_seconds: float | None = None
    max_timeout_retries: int | None = None
    max_transient_retries: int | None = None
    retry_backoff_seconds: float | None = None
    pool_window_size_seconds: float | None = None
    pool_window_stride_seconds: float | None = None
    post_smoothing_window_frames: int | None = None
    post_hysteresis_enter_confidence: float | None = None
    post_hysteresis_exit_confidence: float | None = None
    post_min_segment_duration_seconds: float | None = None
    process_isolation: bool | None = None


@dataclass(frozen=True)
class ResolvedSettingsInputs:
    """All environment-derived configuration inputs, captured once."""

    dataset_folder: Path | None = None
    dataset_manifests: tuple[Path, ...] = ()
    dataset_recipe: str | None = None
    dataset_registry_root: Path | None = None
    dataset_strict_audit: bool | None = None
    data_loader_max_workers: int | None = None
    data_loader_max_failed_files: int | None = None
    data_loader_max_failed_file_ratio: float | None = None
    data_loader_max_failed_file_ratio_per_corpus: float | None = None
    data_loader_max_failed_file_ratio_per_class: float | None = None
    data_loader_max_failures_per_reason: int | None = None
    data_loader_min_remaining_per_class_split: int | None = None
    data_loader_strict_quarantine: bool | None = None
    training_test_size: float | None = None
    training_dev_size: float | None = None
    training_random_state: int | None = None
    # Root re-homing: SER_CACHE_DIR / SER_DATA_DIR relocate every derived
    # folder that is not itself overridden.
    cache_root: Path | None = None
    data_root: Path | None = None
    models_folder: Path | None = None
    model_cache_dir: Path | None = None
    transcripts_folder: Path | None = None
    tmp_folder: Path | None = None
    num_cores: int | None = None
    model_file_name: str | None = None
    secure_model_file_name: str | None = None
    training_report_file_name: str | None = None
    output_schema_version: str | None = None
    artifact_schema_version: str | None = None
    medium_min_window_std: float | None = None
    medium_max_windows_per_clip: int | None = None
    quality_gate_min_uar_delta: float | None = None
    quality_gate_min_macro_f1_delta: float | None = None
    quality_gate_max_medium_segments_per_minute: float | None = None
    quality_gate_min_medium_median_segment_duration_seconds: float | None = None
    enable_profile_pipeline: bool | None = None
    label_ontology_id: str | None = None
    allowed_labels: tuple[str, ...] = ()
    unknown_label_policy: str | None = None
    other_label: str | None = None
    # Profile enables + model ids
    enable_medium_profile: bool | None = None
    enable_accurate_profile: bool | None = None
    enable_accurate_research_profile: bool | None = None
    enable_restricted_backends: bool | None = None
    allowed_restricted_backends: tuple[str, ...] = ()
    new_output_schema: bool | None = None
    medium_model_id: str | None = None
    accurate_model_id: str | None = None
    accurate_research_model_id: str | None = None
    # Accelerator selectors (SER_TORCH_DEVICE / SER_TORCH_DTYPE)
    device: str | None = None
    dtype: str | None = None
    # Transcription
    whisper_backend: str | None = None
    whisper_model: str | None = None
    whisper_demucs: bool | None = None
    whisper_vad: bool | None = None
    whisper_decode_strategy: str | None = None
    whisper_beam_size: int | None = None
    whisper_length_penalty: float | None = None
    separation_model_path: str | None = None
    # Device-memory admission + calibration overrides: SER_TRANSCRIPTION_HBM_*,
    # with the SER_TRANSCRIPTION_MPS_* names honoured as aliases.
    hbm_admission_control: bool | None = None
    hbm_hard_oom_shortcut: bool | None = None
    hbm_admission_min_headroom_mb: float | None = None
    hbm_admission_safety_margin_mb: float | None = None
    calibration_overrides: bool | None = None
    calibration_min_confidence: str | None = None
    calibration_report_max_age_hours: float | None = None
    calibration_report_path: str | None = None
    # The (data, model) mesh
    mesh_data_axis_size: int | None = None
    mesh_model_axis_size: int | None = None
    default_language: str | None = None
    profile_runtime_overrides: dict[ProfileName, ProfileRuntimeOverrides] = field(
        default_factory=dict
    )


_OVERRIDE_READERS = {
    "timeout_seconds": read_env_float,
    "max_timeout_retries": read_env_int,
    "max_transient_retries": read_env_int,
    "retry_backoff_seconds": read_env_float,
    "pool_window_size_seconds": read_env_float,
    "pool_window_stride_seconds": read_env_float,
    "post_smoothing_window_frames": read_env_int,
    "post_hysteresis_enter_confidence": read_env_float,
    "post_hysteresis_exit_confidence": read_env_float,
    "post_min_segment_duration_seconds": read_env_float,
    "process_isolation": read_env_bool,
}


def _capture_profile_overrides(
    env: dict[str, str],
) -> dict[ProfileName, ProfileRuntimeOverrides]:
    captured: dict[ProfileName, ProfileRuntimeOverrides] = {}
    for name in PROFILE_NAMES:
        spec = require_ported(name)
        values = {
            knob: _OVERRIDE_READERS[knob](env, env_name)
            for knob, env_name in spec.runtime_env.items()
        }
        if any(value is not None for value in values.values()):
            captured[name] = ProfileRuntimeOverrides(**values)
    return captured


def _read_label_policy(env: dict[str, str]) -> str | None:
    """``SER_UNKNOWN_LABEL_POLICY``; an unrecognized value reads as "drop"."""
    raw = read_env_str(env, "SER_UNKNOWN_LABEL_POLICY")
    if raw is None:
        return None
    lowered = raw.lower()
    return lowered if lowered in ("drop", "error", "map_to_other") else "drop"


def _split_manifest_paths(raw: str) -> tuple[Path, ...]:
    """Comma-separated manifest paths; path-separated when no comma is present."""
    separator = "," if "," in raw else os.pathsep
    return tuple(
        Path(item.strip()).expanduser() for item in raw.split(separator) if item.strip()
    )


def capture_settings_inputs(env: dict[str, str] | None = None) -> ResolvedSettingsInputs:
    """Captures all recognized environment variables into one frozen snapshot."""
    env = dict(os.environ) if env is None else env
    manifests_raw = read_env_str(env, "SER_DATASET_MANIFESTS")
    manifests = _split_manifest_paths(manifests_raw) if manifests_raw else ()
    allowed_raw = read_env_str(env, "SER_ALLOWED_RESTRICTED_BACKENDS")
    allowed = (
        tuple(item.strip() for item in allowed_raw.split(",") if item.strip())
        if allowed_raw
        else ()
    )
    return ResolvedSettingsInputs(
        dataset_folder=_first(read_env_path, env, "SER_DATASET_FOLDER", "DATASET_FOLDER"),
        dataset_manifests=manifests,
        dataset_recipe=read_env_str(env, "SER_DATASET_RECIPE"),
        dataset_registry_root=read_env_path(env, "SER_DATASET_REGISTRY_ROOT"),
        dataset_strict_audit=_first(
            read_env_bool, env, "SER_DATASET_STRICT_AUDIT", "SER_STRICT_DATASET_AUDIT"
        ),
        data_loader_max_workers=_first(
            read_env_int, env, "SER_DATA_LOADER_MAX_WORKERS", "SER_MAX_WORKERS"
        ),
        data_loader_max_failed_files=_first(
            read_env_int, env, "SER_DATA_LOADER_MAX_FAILED_FILES", "SER_MAX_FAILED_FILES"
        ),
        data_loader_max_failed_file_ratio=_first(
            read_env_float,
            env,
            "SER_DATA_LOADER_MAX_FAILED_FILE_RATIO",
            "SER_MAX_FAILED_FILE_RATIO",
        ),
        data_loader_max_failed_file_ratio_per_corpus=read_env_float(
            env, "SER_MAX_FAILED_FILE_RATIO_PER_CORPUS"
        ),
        data_loader_max_failed_file_ratio_per_class=read_env_float(
            env, "SER_MAX_FAILED_FILE_RATIO_PER_CLASS"
        ),
        data_loader_max_failures_per_reason=read_env_int(
            env, "SER_MAX_FAILURES_PER_REASON"
        ),
        data_loader_min_remaining_per_class_split=read_env_int(
            env, "SER_MIN_REMAINING_PER_CLASS_SPLIT"
        ),
        data_loader_strict_quarantine=read_env_bool(env, "SER_STRICT_QUARANTINE"),
        training_test_size=read_env_float(env, "SER_TEST_SIZE"),
        training_dev_size=read_env_float(env, "SER_DEV_SIZE"),
        training_random_state=read_env_int(env, "SER_RANDOM_STATE"),
        cache_root=read_env_path(env, "SER_CACHE_DIR"),
        data_root=read_env_path(env, "SER_DATA_DIR"),
        models_folder=_first(read_env_path, env, "SER_MODELS_FOLDER", "SER_MODELS_DIR"),
        model_cache_dir=read_env_path(env, "SER_MODEL_CACHE_DIR"),
        transcripts_folder=_first(
            read_env_path, env, "SER_TRANSCRIPTS_FOLDER", "SER_TRANSCRIPTS_DIR"
        ),
        tmp_folder=_first(read_env_path, env, "SER_TMP_FOLDER", "SER_TMP_DIR"),
        num_cores=read_env_int(env, "SER_NUM_CORES"),
        model_file_name=read_env_str(env, "SER_MODEL_FILE_NAME"),
        secure_model_file_name=read_env_str(env, "SER_SECURE_MODEL_FILE_NAME"),
        training_report_file_name=read_env_str(env, "SER_TRAINING_REPORT_FILE_NAME"),
        output_schema_version=read_env_str(env, "SER_OUTPUT_SCHEMA_VERSION"),
        artifact_schema_version=read_env_str(env, "SER_ARTIFACT_SCHEMA_VERSION"),
        medium_min_window_std=read_env_float(env, "SER_MEDIUM_MIN_WINDOW_STD"),
        medium_max_windows_per_clip=read_env_int(env, "SER_MEDIUM_MAX_WINDOWS_PER_CLIP"),
        quality_gate_min_uar_delta=read_env_float(env, "SER_QUALITY_GATE_MIN_UAR_DELTA"),
        quality_gate_min_macro_f1_delta=read_env_float(
            env, "SER_QUALITY_GATE_MIN_MACRO_F1_DELTA"
        ),
        quality_gate_max_medium_segments_per_minute=read_env_float(
            env, "SER_QUALITY_GATE_MAX_MEDIUM_SEGMENTS_PER_MINUTE"
        ),
        quality_gate_min_medium_median_segment_duration_seconds=read_env_float(
            env, "SER_QUALITY_GATE_MIN_MEDIUM_MEDIAN_SEGMENT_DURATION_SECONDS"
        ),
        enable_profile_pipeline=read_env_bool(env, "SER_ENABLE_PROFILE_PIPELINE"),
        label_ontology_id=read_env_str(env, "SER_LABEL_ONTOLOGY_ID"),
        allowed_labels=(
            tuple(
                item.strip()
                for item in (read_env_str(env, "SER_ALLOWED_LABELS") or "").split(",")
                if item.strip()
            )
        ),
        unknown_label_policy=_read_label_policy(env),
        other_label=read_env_str(env, "SER_OTHER_LABEL"),
        enable_medium_profile=read_env_bool(env, "SER_ENABLE_MEDIUM_PROFILE"),
        enable_accurate_profile=read_env_bool(env, "SER_ENABLE_ACCURATE_PROFILE"),
        enable_accurate_research_profile=read_env_bool(
            env, "SER_ENABLE_ACCURATE_RESEARCH_PROFILE"
        ),
        enable_restricted_backends=read_env_bool(env, "SER_ENABLE_RESTRICTED_BACKENDS"),
        allowed_restricted_backends=allowed,
        new_output_schema=_first(
            read_env_bool, env, "SER_NEW_OUTPUT_SCHEMA", "SER_ENABLE_NEW_OUTPUT_SCHEMA"
        ),
        medium_model_id=read_env_str(env, "SER_MEDIUM_MODEL_ID"),
        accurate_model_id=read_env_str(env, "SER_ACCURATE_MODEL_ID"),
        accurate_research_model_id=read_env_str(env, "SER_ACCURATE_RESEARCH_MODEL_ID"),
        device=read_env_str(env, "SER_TORCH_DEVICE"),
        dtype=read_env_str(env, "SER_TORCH_DTYPE"),
        whisper_backend=read_env_str(env, "WHISPER_BACKEND"),
        whisper_model=read_env_str(env, "WHISPER_MODEL"),
        whisper_demucs=read_env_bool(env, "WHISPER_DEMUCS"),
        whisper_vad=read_env_bool(env, "WHISPER_VAD"),
        whisper_decode_strategy=read_env_str(env, "WHISPER_DECODE_STRATEGY"),
        whisper_beam_size=read_env_int(env, "WHISPER_BEAM_SIZE"),
        whisper_length_penalty=read_env_float(env, "WHISPER_LENGTH_PENALTY"),
        separation_model_path=read_env_str(env, "SER_SEPARATION_MODEL_PATH"),
        hbm_admission_control=_first(
            read_env_bool, env,
            "SER_TRANSCRIPTION_HBM_ADMISSION_CONTROL",
            "SER_TRANSCRIPTION_MPS_ADMISSION_CONTROL",
        ),
        hbm_hard_oom_shortcut=_first(
            read_env_bool, env,
            "SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT",
            "SER_TRANSCRIPTION_MPS_HARD_OOM_SHORTCUT",
        ),
        hbm_admission_min_headroom_mb=_first(
            read_env_float, env,
            "SER_TRANSCRIPTION_HBM_MIN_HEADROOM_MB",
            "SER_TRANSCRIPTION_MPS_MIN_HEADROOM_MB",
        ),
        hbm_admission_safety_margin_mb=_first(
            read_env_float, env,
            "SER_TRANSCRIPTION_HBM_SAFETY_MARGIN_MB",
            "SER_TRANSCRIPTION_MPS_SAFETY_MARGIN_MB",
        ),
        calibration_overrides=_first(
            read_env_bool, env,
            "SER_TRANSCRIPTION_HBM_CALIBRATION_OVERRIDES",
            "SER_TRANSCRIPTION_MPS_CALIBRATION_OVERRIDES",
        ),
        calibration_min_confidence=_first(
            read_env_str, env,
            "SER_TRANSCRIPTION_HBM_CALIBRATION_MIN_CONFIDENCE",
            "SER_TRANSCRIPTION_MPS_CALIBRATION_MIN_CONFIDENCE",
        ),
        calibration_report_max_age_hours=_first(
            read_env_float, env,
            "SER_TRANSCRIPTION_HBM_CALIBRATION_REPORT_MAX_AGE_HOURS",
            "SER_TRANSCRIPTION_MPS_CALIBRATION_REPORT_MAX_AGE_HOURS",
        ),
        calibration_report_path=_first(
            read_env_str, env,
            "SER_TRANSCRIPTION_HBM_CALIBRATION_REPORT_PATH",
            "SER_TRANSCRIPTION_MPS_CALIBRATION_REPORT_PATH",
        ),
        mesh_data_axis_size=read_env_int(env, "SER_MESH_DATA_AXIS_SIZE"),
        mesh_model_axis_size=read_env_int(env, "SER_MESH_MODEL_AXIS_SIZE"),
        default_language=_first(
            read_env_str, env, "SER_DEFAULT_LANGUAGE", "DEFAULT_LANGUAGE"
        ),
        profile_runtime_overrides=_capture_profile_overrides(env),
    )


__all__ = [
    "ProfileRuntimeOverrides",
    "ResolvedSettingsInputs",
    "SettingsInputError",
    "capture_settings_inputs",
    "read_env_bool",
    "read_env_float",
    "read_env_int",
    "read_env_path",
    "read_env_str",
]
