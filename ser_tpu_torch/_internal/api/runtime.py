"""Internal runtime API: the profile registry, the profile override, the inference and the training workflows.

Counterpart of ``ser_tpu/_internal/api/runtime.py`` (``list_profiles``,
``apply_cli_profile_override``, ``load_profile``, ``run_inference_workflow``,
``infer`` and ``train``), for the four profiles. A workflow builds its pipeline
and runs under ``settings_override`` of its settings, so ``get_settings`` inside
it returns them; ``pipeline_builder`` replaces the runtime pipeline.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from pathlib import Path

from ser_tpu_torch._internal.config.bootstrap import settings_override
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime.pipeline import create_runtime_pipeline
from ser_tpu_torch._internal.runtime.registry import ensure_profile_supported, resolve_runtime_capability
from ser_tpu_torch.profiles import PROFILE_NAMES, ProfileName, require_ported
from ser_tpu_torch.runtime.contracts import InferenceExecution, InferenceRequest, SubtitleFormat

type PipelineBuilder = Callable[[AppConfig], object]


def list_profiles() -> tuple[ProfileName, ...]:
    """All registered runtime profile names."""
    return PROFILE_NAMES


def apply_cli_profile_override(settings: AppConfig, profile: ProfileName | None) -> AppConfig:
    """Projects one requested profile into the settings' runtime flags and transcription defaults."""
    if profile is None:
        return settings
    if profile not in PROFILE_NAMES:
        raise ValueError(f"Unknown profile {profile!r}. Expected one of {PROFILE_NAMES}.")
    flags = dataclasses.replace(
        settings.runtime_flags,
        profile_pipeline=True,
        medium_profile=profile == "medium",
        accurate_profile=profile == "accurate",
        accurate_research_profile=profile == "accurate-research",
    )
    tx_defaults = require_ported(profile).transcription_defaults
    transcription = dataclasses.replace(
        settings.transcription,
        backend_id=tx_defaults.backend_id,
        use_demucs=tx_defaults.use_demucs,
        use_vad=tx_defaults.use_vad,
    )
    return dataclasses.replace(settings, runtime_flags=flags, transcription=transcription)


def load_profile(profile: ProfileName, *, settings: AppConfig) -> None:
    """Validates that one profile can run under the given settings; raises ``UnsupportedProfileError`` if not.

    Builds the backend hooks, which loads no weights: a hook builds its
    backend at its first request.
    """
    resolved = apply_cli_profile_override(settings, profile)
    from ser_tpu_torch._internal.runtime.backend_hooks import build_backend_hooks

    hooks = build_backend_hooks(resolved)
    capability = resolve_runtime_capability(profile, settings=resolved, available_hooks=frozenset(hooks))
    ensure_profile_supported(capability)


def run_inference_workflow(
    request: InferenceRequest,
    *,
    settings: AppConfig,
    pipeline_builder: PipelineBuilder | None = None,
) -> InferenceExecution:
    """Builds the pipeline under scoped settings and runs one request."""
    builder = pipeline_builder if pipeline_builder is not None else create_runtime_pipeline
    with settings_override(settings):
        pipeline = builder(settings)
        return pipeline.run_inference(request)  # type: ignore[attr-defined]


def infer(
    file_path: str | Path,
    *,
    profile: ProfileName | None = None,
    language: str | None = None,
    save_transcript: bool = False,
    include_transcript: bool = True,
    subtitle_output_path: str | None = None,
    subtitle_format: SubtitleFormat | None = None,
    settings: AppConfig,
    pipeline_builder: PipelineBuilder | None = None,
) -> InferenceExecution:
    """Library inference entry point: one request through the runtime pipeline.

    ``save_transcript`` writes the timeline's CSV under the settings' timeline
    folder; a subtitle path or format writes ASS, SRT or VTT subtitles (a
    blank path or an unknown format raises before any compute).
    """
    resolved = apply_cli_profile_override(settings, profile)
    request = InferenceRequest(
        file_path=str(file_path),
        language=language if language is not None else resolved.default_language,
        save_transcript=save_transcript,
        include_transcript=include_transcript,
        subtitle_output_path=subtitle_output_path,
        subtitle_format=subtitle_format,
    )
    return run_inference_workflow(request, settings=resolved, pipeline_builder=pipeline_builder)


def train(
    *,
    profile: ProfileName | None = None,
    settings: AppConfig,
    pipeline_builder: PipelineBuilder | None = None,
) -> None:
    """Library training entry point: the active profile's training through the runtime pipeline.

    The device is resolved first: with no card and no request for the CPU it
    raises before readiness touches the corpus.
    """
    resolved = apply_cli_profile_override(settings, profile)
    resolve_device(resolved.torch_runtime.device)
    builder = pipeline_builder if pipeline_builder is not None else create_runtime_pipeline
    with settings_override(resolved):
        builder(resolved).run_training()  # type: ignore[attr-defined]


__all__ = [
    "apply_cli_profile_override",
    "infer",
    "list_profiles",
    "load_profile",
    "run_inference_workflow",
    "train",
]
