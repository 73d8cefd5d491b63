"""Runtime pipeline: training of the active profile, and inference (profile check →
emotion inference → transcript → timeline).

Counterpart of ``ser_tpu/_internal/runtime/pipeline.py``: ``run_training``
dispatches to the active profile's training entry point (``train_fns``, by
default the four profiles' own), and ``run_inference`` keeps the same phase
timings, the transcript lane behind ``include_transcript``
(``extract_transcript``), the same timeline merge of words and emotion
segments, and the same ``InferenceExecution``. CSV and subtitle export are
not ported yet and raise ``NotImplementedError`` (``ROADMAP.md``).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.runtime import phases
from ser_tpu_torch._internal.runtime.backend_hooks import BackendHook, build_backend_hooks
from ser_tpu_torch._internal.runtime.errors import UnsupportedProfileError
from ser_tpu_torch._internal.transcript.extractor import extract_transcript
from ser_tpu_torch._internal.utils import timeline as timeline_utils
from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord
from ser_tpu_torch.profiles import ProfileName, require_ported, resolve_profile_name
from ser_tpu_torch.runtime.contracts import InferenceExecution, InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult, to_legacy_emotion_segments

type TrainFn = Callable[[AppConfig], object]


def _refuse_unported_outputs(request: InferenceRequest) -> None:
    unported = [
        name
        for name, requested in (
            ("save_transcript=True (CSV export)", request.save_transcript),
            ("subtitle export", request.subtitle_output_path is not None or request.subtitle_format is not None),
        )
        if requested
    ]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)} is not ported to ser_tpu_torch yet; see ROADMAP.md. "
            "Use ser_tpu for it."
        )


@dataclass(frozen=True)
class RuntimePipeline:
    """Orchestrates training and inference for the active profile."""

    settings: AppConfig
    backend_hooks: dict[str, BackendHook]
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
        _refuse_unported_outputs(request)
        profile = self.active_profile
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
                    transcript = extract_transcript(
                        request.file_path,
                        language=request.language,
                        profile=profile,
                        settings=self.settings,
                        timings=timings,
                    )
            with phases.timed_phase(phases.PHASE_TIMELINE_BUILD, timings):
                timeline = timeline_utils.build_timeline(transcript, emotions)
            with phases.timed_phase(phases.PHASE_TIMELINE_OUTPUT, timings):
                self.print_timeline_fn(timeline)
        return InferenceExecution(
            profile=profile,
            output_schema_version=detailed.schema_version,
            backend_id=backend_id,
            emotions=emotions,
            transcript=transcript,
            timeline=timeline,
            used_backend_path=True,
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
