"""Environment capture into the port's settings snapshot.

Counterpart of ``ser_tpu/_internal/config/{settings_inputs,settings_builder,
bootstrap}.py`` for the fields the four profiles' inference paths read.
The same ``SER_*`` variables are honoured with the same meaning, so one
environment configures both packages: ``SER_ENABLE_MEDIUM_PROFILE``,
``SER_ENABLE_ACCURATE_PROFILE``, ``SER_ENABLE_ACCURATE_RESEARCH_PROFILE``,
``SER_ENABLE_RESTRICTED_BACKENDS``, ``SER_ALLOWED_RESTRICTED_BACKENDS``
(comma-separated), ``SER_MODELS_FOLDER`` (alias ``SER_MODELS_DIR``),
``SER_MODEL_FILE_NAME``, ``SER_CACHE_DIR``, ``SER_DATA_DIR``,
``SER_MODEL_CACHE_DIR``, ``SER_MEDIUM_MODEL_ID``, ``SER_ACCURATE_MODEL_ID``,
``SER_ACCURATE_RESEARCH_MODEL_ID``, ``SER_OUTPUT_SCHEMA_VERSION``,
``SER_TORCH_DEVICE``, ``SER_TORCH_DTYPE``, ``SER_DEFAULT_LANGUAGE``,
``SER_MESH_DATA_AXIS_SIZE``, ``SER_MESH_MODEL_AXIS_SIZE``,
``SER_TMP_FOLDER`` (alias ``SER_TMP_DIR``), ``SER_TRANSCRIPTS_FOLDER`` (alias
``SER_TRANSCRIPTS_DIR``; else ``<SER_DATA_DIR>/transcripts`` when that is
set), the ``SER_<PROFILE>_<KNOB>``
runtime overrides of the four profiles (``SER_<PROFILE>_TIMEOUT_SECONDS``,
``..._MAX_TIMEOUT_RETRIES``, ``..._MAX_TRANSIENT_RETRIES``,
``..._RETRY_BACKOFF_SECONDS`` and ``..._PROCESS_ISOLATION`` among them), the
data layer's ``SER_DATASET_FOLDER`` (alias ``DATASET_FOLDER``),
``SER_DATASET_MANIFESTS`` (comma-separated, or path-separated when no comma
is present), ``SER_DATASET_RECIPE`` (which turns the strict audit on unless
``SER_DATASET_STRICT_AUDIT`` (alias ``SER_STRICT_DATASET_AUDIT``) says
otherwise), ``SER_DATASET_REGISTRY_ROOT``, ``SER_DATA_LOADER_MAX_WORKERS``
(alias ``SER_MAX_WORKERS``), ``SER_DATA_LOADER_MAX_FAILED_FILE_RATIO`` (alias
``SER_MAX_FAILED_FILE_RATIO``), the quarantine budgets
``SER_DATA_LOADER_MAX_FAILED_FILES`` (alias ``SER_MAX_FAILED_FILES``),
``SER_MAX_FAILED_FILE_RATIO_PER_CORPUS`` and ``..._PER_CLASS`` (each the global
ratio unless set), ``SER_MAX_FAILURES_PER_REASON``,
``SER_MIN_REMAINING_PER_CLASS_SPLIT`` and ``SER_STRICT_QUARANTINE``,
``SER_TEST_SIZE``, ``SER_DEV_SIZE``, ``SER_RANDOM_STATE``, the encoder
profiles' window noise controls ``SER_MEDIUM_MIN_WINDOW_STD`` and
``SER_MEDIUM_MAX_WINDOWS_PER_CLIP``, the label
ontology's ``SER_LABEL_ONTOLOGY_ID``, ``SER_ALLOWED_LABELS``,
``SER_UNKNOWN_LABEL_POLICY`` (an unknown value reads as ``drop``) and
``SER_OTHER_LABEL``, and the transcript lane's ``WHISPER_BACKEND``, ``WHISPER_MODEL``,
``WHISPER_DEMUCS``, ``WHISPER_VAD``, ``WHISPER_DECODE_STRATEGY``,
``WHISPER_BEAM_SIZE`` (1-16), ``WHISPER_LENGTH_PENALTY`` (finite, 0-5),
``SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT`` (alias ``..._MPS_...``) and
``SER_SEPARATION_MODEL_PATH``. ``SER_DECODE_INT8`` is read where the
transcription model is built, as in the JAX package.
``SER_ALLOW_RANDOM_INIT`` / ``SER_RANDOM_INIT_SIZE`` are read where the
weights are resolved, ``SER_DEVICE_POOLING`` where the medium profile
encodes, ``SER_FAST_DEVICE_FRAMING`` where the fast profile frames its clip,
and ``SER_RESTRICTED_BACKENDS_CONSENT_FILE`` where consent is read, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections.abc import Callable, Mapping
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"0", "false", "no", "off"}


class SettingsInputError(ValueError):
    """Raised when an environment variable holds an unparseable value."""


def _str(env: Mapping[str, str], name: str) -> str | None:
    raw = env.get(name)
    if raw is None:
        return None
    return raw.strip() or None


def _bool(env: Mapping[str, str], name: str) -> bool | None:
    raw = _str(env, name)
    if raw is None:
        return None
    if raw.lower() in _TRUTHY:
        return True
    if raw.lower() in _FALSY:
        return False
    raise SettingsInputError(f"Env var {name}={raw!r} is not a boolean.")


def _number(kind: Callable[[str], object]):
    def read(env: Mapping[str, str], name: str):
        raw = _str(env, name)
        if raw is None:
            return None
        try:
            return kind(raw)
        except ValueError as err:
            raise SettingsInputError(f"Env var {name}={raw!r} is not {kind.__name__}.") from err

    return read


def _path(env: Mapping[str, str], name: str) -> Path | None:
    raw = _str(env, name)
    return Path(raw).expanduser() if raw is not None else None


#: The profile runtime knobs these paths read, each from ``SER_<PROFILE>_<KNOB>``.
_KNOB_READERS = {
    "timeout_seconds": _number(float),
    "max_timeout_retries": _number(int),
    "max_transient_retries": _number(int),
    "retry_backoff_seconds": _number(float),
    "pool_window_size_seconds": _number(float),
    "pool_window_stride_seconds": _number(float),
    "post_smoothing_window_frames": _number(int),
    "post_hysteresis_enter_confidence": _number(float),
    "post_hysteresis_exit_confidence": _number(float),
    "post_min_segment_duration_seconds": _number(float),
    "process_isolation": _bool,
}


def _changes(**values: object) -> dict[str, object]:
    return {name: value for name, value in values.items() if value is not None}


def _first(read, env: Mapping[str, str], *names: str):
    """The first of ``names`` that is set, read by ``read``."""
    for name in names:
        value = read(env, name)
        if value is not None:
            return value
    return None


def _manifest_paths(env: Mapping[str, str]) -> tuple[Path, ...] | None:
    raw = _str(env, "SER_DATASET_MANIFESTS")
    if raw is None:
        return None
    separator = "," if "," in raw else os.pathsep
    return tuple(Path(item.strip()).expanduser() for item in raw.split(separator) if item.strip()) or None


def _data_sections(env: Mapping[str, str], base: AppConfig) -> dict[str, object]:
    """The dataset, loader, training and ontology sections (the JAX package's variables and rules)."""
    recipe = _str(env, "SER_DATASET_RECIPE")
    strict_audit = _first(_bool, env, "SER_DATASET_STRICT_AUDIT", "SER_STRICT_DATASET_AUDIT")
    if strict_audit is None and recipe is not None:
        strict_audit = True  # a pinned recipe implies the strict audit unless relaxed
    dataset = dataclasses.replace(
        base.dataset,
        **_changes(
            folder=_first(_path, env, "SER_DATASET_FOLDER", "DATASET_FOLDER"),
            manifest_paths=_manifest_paths(env),
            recipe=recipe,
            strict_audit=strict_audit,
            registry_root=_path(env, "SER_DATASET_REGISTRY_ROOT"),
        ),
    )
    ratio = _first(_number(float), env, "SER_DATA_LOADER_MAX_FAILED_FILE_RATIO", "SER_MAX_FAILED_FILE_RATIO")
    per_corpus = _number(float)(env, "SER_MAX_FAILED_FILE_RATIO_PER_CORPUS")
    per_class = _number(float)(env, "SER_MAX_FAILED_FILE_RATIO_PER_CLASS")
    data_loader = dataclasses.replace(
        base.data_loader,
        **_changes(
            max_workers=_first(_number(int), env, "SER_DATA_LOADER_MAX_WORKERS", "SER_MAX_WORKERS"),
            max_failed_file_ratio=ratio,
            max_failed_files=_first(_number(int), env, "SER_DATA_LOADER_MAX_FAILED_FILES", "SER_MAX_FAILED_FILES"),
            # The per-corpus and per-class budgets follow the global ratio unless set themselves.
            max_failed_file_ratio_per_corpus=ratio if per_corpus is None else per_corpus,
            max_failed_file_ratio_per_class=ratio if per_class is None else per_class,
            max_failures_per_reason=_number(int)(env, "SER_MAX_FAILURES_PER_REASON"),
            min_remaining_per_class_split=_number(int)(env, "SER_MIN_REMAINING_PER_CLASS_SPLIT"),
            strict_quarantine=_bool(env, "SER_STRICT_QUARANTINE"),
        ),
    )
    training = dataclasses.replace(
        base.training,
        **_changes(
            test_size=_number(float)(env, "SER_TEST_SIZE"),
            dev_size=_number(float)(env, "SER_DEV_SIZE"),
            random_state=_number(int)(env, "SER_RANDOM_STATE"),
        ),
    )
    medium_training = dataclasses.replace(
        base.medium_training,
        **_changes(
            min_window_std=_number(float)(env, "SER_MEDIUM_MIN_WINDOW_STD"),
            max_windows_per_clip=_number(int)(env, "SER_MEDIUM_MAX_WINDOWS_PER_CLIP"),
        ),
    )
    policy = _str(env, "SER_UNKNOWN_LABEL_POLICY")
    if policy is not None:
        policy = policy.lower() if policy.lower() in ("drop", "error", "map_to_other") else "drop"
    allowed = tuple(item.strip() for item in (_str(env, "SER_ALLOWED_LABELS") or "").split(",") if item.strip())
    ontology = dataclasses.replace(
        base.ontology,
        **_changes(
            ontology_id=_str(env, "SER_LABEL_ONTOLOGY_ID"),
            allowed_labels=allowed or None,
            unknown_label_policy=policy,
            other_label=_str(env, "SER_OTHER_LABEL"),
        ),
    )
    return {
        "dataset": dataset,
        "data_loader": data_loader,
        "training": training,
        "medium_training": medium_training,
        "ontology": ontology,
    }


def build_settings(env: Mapping[str, str] | None = None) -> AppConfig:
    """Builds one settings snapshot from ``env`` (default: ``os.environ``)."""
    env = dict(os.environ) if env is None else env
    base = AppConfig()

    cache_root = _path(env, "SER_CACHE_DIR")
    data_root = _path(env, "SER_DATA_DIR")
    model_cache_dir = _path(env, "SER_MODEL_CACHE_DIR")
    if model_cache_dir is None and cache_root is not None:
        model_cache_dir = cache_root / "model-cache"
    models_folder = _path(env, "SER_MODELS_FOLDER") or _path(env, "SER_MODELS_DIR")
    if models_folder is None and data_root is not None:
        models_folder = data_root / "models"
    models = dataclasses.replace(
        base.models,
        **_changes(
            folder=models_folder,
            model_cache_dir=model_cache_dir,
            medium_model_id=_str(env, "SER_MEDIUM_MODEL_ID"),
            accurate_model_id=_str(env, "SER_ACCURATE_MODEL_ID"),
            accurate_research_model_id=_str(env, "SER_ACCURATE_RESEARCH_MODEL_ID"),
            model_file_name=_str(env, "SER_MODEL_FILE_NAME"),
        ),
    )

    flags = dataclasses.replace(
        base.runtime_flags,
        profile_pipeline=bool(_bool(env, "SER_ENABLE_PROFILE_PIPELINE")),
        medium_profile=bool(_bool(env, "SER_ENABLE_MEDIUM_PROFILE")),
        accurate_profile=bool(_bool(env, "SER_ENABLE_ACCURATE_PROFILE")),
        accurate_research_profile=bool(_bool(env, "SER_ENABLE_ACCURATE_RESEARCH_PROFILE")),
        restricted_backends=bool(_bool(env, "SER_ENABLE_RESTRICTED_BACKENDS")),
        allowed_restricted_backends=tuple(
            item.strip() for item in (_str(env, "SER_ALLOWED_RESTRICTED_BACKENDS") or "").split(",") if item.strip()
        ),
    )

    def runtime_for(prefix: str, runtime):
        return dataclasses.replace(
            runtime, **_changes(**{knob: read(env, f"{prefix}_{knob.upper()}") for knob, read in _KNOB_READERS.items()})
        )

    schema = dataclasses.replace(
        base.schema, **_changes(output_schema_version=_str(env, "SER_OUTPUT_SCHEMA_VERSION"))
    )
    torch_runtime = dataclasses.replace(
        base.torch_runtime,
        **_changes(device=_str(env, "SER_TORCH_DEVICE"), dtype=_str(env, "SER_TORCH_DTYPE")),
    )
    whisper_model = _str(env, "WHISPER_MODEL")
    if whisper_model is not None:
        models = dataclasses.replace(
            models, whisper_model=dataclasses.replace(models.whisper_model, name=whisper_model)
        )
    decode_strategy = _str(env, "WHISPER_DECODE_STRATEGY")
    if decode_strategy is not None and decode_strategy not in ("greedy", "beam"):
        raise SettingsInputError(f"WHISPER_DECODE_STRATEGY must be 'greedy' or 'beam', got {decode_strategy!r}.")
    beam_size = _number(int)(env, "WHISPER_BEAM_SIZE")
    if beam_size is not None and not 1 <= beam_size <= 16:
        raise SettingsInputError("WHISPER_BEAM_SIZE must be in [1, 16].")
    length_penalty = _number(float)(env, "WHISPER_LENGTH_PENALTY")
    # A negative penalty makes the shortest hypothesis always win, and a non-finite one poisons every score.
    if length_penalty is not None and not (math.isfinite(length_penalty) and 0.0 <= length_penalty <= 5.0):
        raise SettingsInputError("WHISPER_LENGTH_PENALTY must be finite and in [0, 5].")
    hard_oom_shortcut = _bool(env, "SER_TRANSCRIPTION_HBM_HARD_OOM_SHORTCUT")
    if hard_oom_shortcut is None:
        hard_oom_shortcut = _bool(env, "SER_TRANSCRIPTION_MPS_HARD_OOM_SHORTCUT")
    transcription = dataclasses.replace(
        base.transcription,
        **_changes(
            backend_id=_str(env, "WHISPER_BACKEND"),
            use_demucs=_bool(env, "WHISPER_DEMUCS"),
            use_vad=_bool(env, "WHISPER_VAD"),
            decode_strategy=decode_strategy,
            beam_size=beam_size,
            length_penalty=length_penalty,
            hbm_hard_oom_shortcut_enabled=hard_oom_shortcut,
            separation_model_path=_path(env, "SER_SEPARATION_MODEL_PATH"),
        ),
    )
    mesh = dataclasses.replace(
        base.mesh,
        **_changes(
            data_axis_size=_number(int)(env, "SER_MESH_DATA_AXIS_SIZE"),
            model_axis_size=_number(int)(env, "SER_MESH_MODEL_AXIS_SIZE"),
        ),
    )
    transcripts_folder = _first(_path, env, "SER_TRANSCRIPTS_FOLDER", "SER_TRANSCRIPTS_DIR")
    if transcripts_folder is None and data_root is not None:
        transcripts_folder = data_root / "transcripts"
    timeline = dataclasses.replace(base.timeline, **_changes(folder=transcripts_folder))
    tmp_folder = _path(env, "SER_TMP_FOLDER") or _path(env, "SER_TMP_DIR")
    if tmp_folder is None and cache_root is not None:
        tmp_folder = cache_root / "tmp"
    return dataclasses.replace(
        base,
        models=models,
        runtime_flags=flags,
        fast_runtime=runtime_for("SER_FAST", base.fast_runtime),
        medium_runtime=runtime_for("SER_MEDIUM", base.medium_runtime),
        accurate_runtime=runtime_for("SER_ACCURATE", base.accurate_runtime),
        accurate_research_runtime=runtime_for("SER_ACCURATE_RESEARCH", base.accurate_research_runtime),
        schema=schema,
        torch_runtime=torch_runtime,
        transcription=transcription,
        timeline=timeline,
        mesh=mesh,
        tmp_folder=tmp_folder if tmp_folder is not None else base.tmp_folder,
        default_language=_str(env, "SER_DEFAULT_LANGUAGE") or base.default_language,
        **_data_sections(env, base),
    )


def reload_settings() -> AppConfig:
    """A fresh snapshot of the current process environment."""
    return build_settings()


__all__ = ["SettingsInputError", "build_settings", "reload_settings"]
