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
``SER_TMP_FOLDER`` (alias ``SER_TMP_DIR``), the ``SER_<PROFILE>_<KNOB>``
runtime overrides of the four profiles, and the transcript lane's
``WHISPER_BACKEND``, ``WHISPER_MODEL``, ``WHISPER_DEMUCS``, ``WHISPER_VAD``,
``WHISPER_DECODE_STRATEGY`` and ``SER_SEPARATION_MODEL_PATH``.
``SER_ALLOW_RANDOM_INIT`` / ``SER_RANDOM_INIT_SIZE`` are read where the
weights are resolved, ``SER_DEVICE_POOLING`` where the medium profile
encodes, ``SER_FAST_DEVICE_FRAMING`` where the fast profile frames its clip,
and ``SER_RESTRICTED_BACKENDS_CONSENT_FILE`` where consent is read, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
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
    "pool_window_size_seconds": _number(float),
    "pool_window_stride_seconds": _number(float),
    "post_smoothing_window_frames": _number(int),
    "post_hysteresis_enter_confidence": _number(float),
    "post_hysteresis_exit_confidence": _number(float),
    "post_min_segment_duration_seconds": _number(float),
}


def _changes(**values: object) -> dict[str, object]:
    return {name: value for name, value in values.items() if value is not None}


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
    transcription = dataclasses.replace(
        base.transcription,
        **_changes(
            backend_id=_str(env, "WHISPER_BACKEND"),
            use_demucs=_bool(env, "WHISPER_DEMUCS"),
            use_vad=_bool(env, "WHISPER_VAD"),
            decode_strategy=decode_strategy,
            separation_model_path=_path(env, "SER_SEPARATION_MODEL_PATH"),
        ),
    )
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
        tmp_folder=tmp_folder if tmp_folder is not None else base.tmp_folder,
        default_language=_str(env, "SER_DEFAULT_LANGUAGE") or base.default_language,
    )


def reload_settings() -> AppConfig:
    """A fresh snapshot of the current process environment."""
    return build_settings()


__all__ = ["SettingsInputError", "build_settings", "reload_settings"]
