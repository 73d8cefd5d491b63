"""Internal runtime API: profile override, the inference and the training workflows.

Counterpart of ``ser_tpu/_internal/api/runtime.py`` (``apply_cli_profile_override``,
``infer`` and ``train``), for the four profiles.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime.pipeline import create_runtime_pipeline
from ser_tpu_torch.profiles import PROFILE_NAMES, ProfileName, require_ported
from ser_tpu_torch.runtime.contracts import InferenceExecution, InferenceRequest, SubtitleFormat

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
    return create_runtime_pipeline(resolved).run_inference(request)


def train(*, profile: ProfileName | None = None, settings: AppConfig) -> None:
    """Library training entry point: the active profile's training through the runtime pipeline.

    The device is resolved first: with no card and no request for the CPU it
    raises before readiness touches the corpus.
    """
    resolved = apply_cli_profile_override(settings, profile)
    resolve_device(resolved.torch_runtime.device)
    create_runtime_pipeline(resolved).run_training()


__all__ = ["apply_cli_profile_override", "infer", "train"]
