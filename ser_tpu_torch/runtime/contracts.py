"""Runtime pipeline contracts for train/inference orchestration.

Parity surface: reference ``ser/runtime/contracts.py:16-45``. Field names,
ordering, and defaults are the compatibility contract — downstream consumers
construct ``InferenceRequest`` positionally and unpack ``InferenceExecution``
attributes by name.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Literal

from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord
from ser_tpu_torch.profiles import ProfileName
from ser_tpu_torch.runtime.schema import InferenceResult

#: Supported subtitle export containers.
type SubtitleFormat = Literal["ass", "srt", "vtt"]


@dataclass(frozen=True)
class InferenceRequest:
    """Input contract for one inference execution.

    ``file_path``/``language`` are required; transcript and subtitle outputs
    are opt-in. ``subtitle_format`` may be omitted when the output path carries
    a recognizable suffix.
    """

    file_path: str
    language: str
    # Output opt-ins (CSV transcript save, transcript inclusion, subtitles).
    save_transcript: bool = False
    include_transcript: bool = True
    subtitle_output_path: str | None = None
    subtitle_format: SubtitleFormat | None = None


@dataclass(frozen=True)
class InferenceExecution:
    """Output contract for one inference execution.

    Carries the resolved profile/backend identity, the three result streams
    (emotion segments, transcript words, merged timeline rows), artifact paths
    when exports were requested, the full detailed result, and the per-phase
    wall-clock timings keyed by the canonical phase ids
    (``_internal/runtime/phases.py``).
    """

    # Identity of the execution path that produced this result.
    profile: ProfileName
    output_schema_version: str
    backend_id: str
    # The three result streams.
    emotions: list[EmotionSegment]
    transcript: list[TranscriptWord]
    timeline: list[TimelineEntry]
    used_backend_path: bool = False
    # Export artifact locations (None unless requested).
    timeline_csv_path: str | None = None
    subtitle_path: str | None = None
    # Frame/segment detail + canonical phase timings.
    detailed_result: InferenceResult | None = None
    phase_timings_seconds: dict[str, float] = field(default_factory=dict)


#: A profile boundary callable: one request in, one detailed result out.
type BackendInferenceCallable = Callable[[InferenceRequest], InferenceResult]

__all__ = [
    "BackendInferenceCallable",
    "InferenceExecution",
    "InferenceRequest",
    "SubtitleFormat",
]
