"""Runtime pipeline: training of the active profile, and inference (profile check →
emotion inference → transcript → timeline).

Counterpart of ``ser_tpu/_internal/runtime/pipeline.py``: ``run_training``
dispatches to the active profile's training entry point (``train_fns``, by
default the four profiles' own), and ``run_inference`` keeps the same phase
timings, the transcript lane behind ``include_transcript``
(``extract_transcript``), the same timeline merge of words and emotion
segments, the same exports (the timeline's CSV with ``save_transcript``,
ASS/SRT/VTT subtitles with ``subtitle_output_path`` or ``subtitle_format``,
the request validated before any compute) and the same
``InferenceExecution``.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.runtime import phases
from ser_tpu_torch._internal.runtime.backend_hooks import BackendHook, build_backend_hooks
from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError
from ser_tpu_torch._internal.transcript.extractor import extract_transcript
from ser_tpu_torch._internal.utils import subtitles as subtitles_utils
from ser_tpu_torch._internal.utils import timeline as timeline_utils
from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord
from ser_tpu_torch.profiles import ProfileName, require_ported, resolve_profile_name
from ser_tpu_torch.runtime.contracts import InferenceExecution, InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult, to_legacy_emotion_segments

type TranscriptFn = Callable[..., list[TranscriptWord]]
type TrainFn = Callable[[AppConfig], object]


def _default_transcript_fn(
    file_path: str,
    language: str,
    profile: ProfileName,
    settings: AppConfig,
    timings: dict[str, float] | None = None,
) -> list[TranscriptWord]:
    return extract_transcript(file_path, language=language, profile=profile, settings=settings, timings=timings)


@dataclass(frozen=True)
class RuntimePipeline:
    """Orchestrates training and inference for the active profile."""

    settings: AppConfig
    backend_hooks: dict[str, BackendHook]
    transcript_fn: TranscriptFn = _default_transcript_fn
    train_fns: dict[ProfileName, TrainFn] = field(default_factory=dict)
    print_timeline_fn: Callable[[list[TimelineEntry]], None] = timeline_utils.print_timeline

    @property
    def active_profile(self) -> ProfileName:
        flags = self.settings.runtime_flags
        return resolve_profile_name(
            medium_profile=flags.medium_profile,
            accurate_profile=flags.accurate_profile,
            accurate_research_profile=flags.accurate_research_profile,
        )

    def run_training(self) -> None:
        """Runs training for the active profile."""
        profile = self.active_profile
        train_fn = self.train_fns.get(profile)
        if train_fn is None:
            raise NotImplementedError(f"Training for profile {profile!r} is not wired.")
        train_fn(self.settings)

    def run_inference(self, request: InferenceRequest) -> InferenceExecution:
        """Runs one inference workflow end to end."""
        profile = self.active_profile
        # Validate the subtitle request before any compute: a blank path or a
        # format that cannot be derived is an input error, and surfacing it
        # after inference and transcription would discard their results.
        subtitles_utils.resolve_subtitle_export_request(
            output_path=request.subtitle_output_path, subtitle_format=request.subtitle_format
        )
        backend_id = require_ported(profile).backend_id
        timings: dict[str, float] = {}
        with phases.timed_phase(phases.PHASE_WORKFLOW_TOTAL, timings):
            with phases.timed_phase(phases.PHASE_EMOTION_SETUP, timings):
                hook = self.backend_hooks.get(backend_id)
                if hook is None:
                    raise UnsupportedProfileError(
                        f"Profile {profile!r} backend {backend_id!r} has no hook: the profile "
                        f"is not enabled (SER_ENABLE_{profile.upper().replace('-', '_')}_PROFILE=1), "
                        "or its restricted backend is gated (SER_ENABLE_RESTRICTED_BACKENDS=1 and "
                        "recorded consent or SER_ALLOWED_RESTRICTED_BACKENDS).",
                        profile=profile,
                    )
            with phases.timed_phase(phases.PHASE_EMOTION_INFERENCE, timings):
                detailed: InferenceResult = hook(request)
                emotions: list[EmotionSegment] = to_legacy_emotion_segments(detailed)
            transcript: list[TranscriptWord] = []
            if request.include_transcript:
                # extract_transcript records transcription_setup and
                # transcription_model_load into the same dict; this phase
                # covers the whole lane.
                with phases.timed_phase(phases.PHASE_TRANSCRIPTION, timings):
                    transcript = self.transcript_fn(
                        request.file_path, request.language, profile, self.settings, timings
                    )
            with phases.timed_phase(phases.PHASE_TIMELINE_BUILD, timings):
                timeline = timeline_utils.build_timeline(transcript, emotions)
            timeline_csv_path: str | None = None
            subtitle_path: str | None = None
            with phases.timed_phase(phases.PHASE_TIMELINE_OUTPUT, timings):
                self.print_timeline_fn(timeline)
                if request.save_transcript:
                    timeline_csv_path = timeline_utils.save_timeline_to_csv(
                        timeline, request.file_path, timeline_config=self.settings.timeline
                    )
                export = subtitles_utils.resolve_subtitle_export_request(
                    output_path=request.subtitle_output_path, subtitle_format=request.subtitle_format
                )
                if export is not None:
                    subtitle_format, output_path = export
                    subtitle_path = subtitles_utils.save_timeline_to_subtitles(
                        timeline,
                        request.file_path,
                        subtitle_format=subtitle_format,
                        output_path=output_path,
                        timeline_config=self.settings.timeline,
                    )
        return InferenceExecution(
            profile=profile,
            output_schema_version=detailed.schema_version,
            backend_id=backend_id,
            emotions=emotions,
            transcript=transcript,
            timeline=timeline,
            used_backend_path=True,
            timeline_csv_path=timeline_csv_path,
            subtitle_path=subtitle_path,
            detailed_result=detailed,
            phase_timings_seconds=timings,
        )


def _default_train_fns() -> dict[ProfileName, TrainFn]:
    from ser_tpu_torch._internal.models.fast_training import train_fast_model
    from ser_tpu_torch._internal.models.training_entrypoints import (
        train_accurate_model,
        train_accurate_research_model,
        train_medium_model,
    )

    return {
        "fast": lambda settings: train_fast_model(settings=settings),
        "medium": lambda settings: train_medium_model(settings=settings),
        "accurate": lambda settings: train_accurate_model(settings=settings),
        "accurate-research": lambda settings: train_accurate_research_model(settings=settings),
    }


def create_runtime_pipeline(settings: AppConfig) -> RuntimePipeline:
    """Wires the default pipeline for one settings snapshot."""
    return RuntimePipeline(
        settings=settings, backend_hooks=build_backend_hooks(settings), train_fns=_default_train_fns()
    )


__all__ = ["RuntimePipeline", "create_runtime_pipeline"]
