"""Versioned runtime inference schema and compatibility adapters.

Parity surface: reference ``ser/runtime/schema.py:9-53`` — same schema version
strings and dataclass shapes so serialized results interoperate.
"""

from __future__ import annotations

from dataclasses import dataclass

from ser_tpu_torch.domain import EmotionSegment

OUTPUT_SCHEMA_VERSION = "v1"
ARTIFACT_SCHEMA_VERSION = "v2"


@dataclass(frozen=True)
class FramePrediction:
    """One frame-level inference prediction."""

    start_seconds: float
    end_seconds: float
    emotion: str
    confidence: float
    probabilities: dict[str, float] | None


@dataclass(frozen=True)
class SegmentPrediction:
    """Merged segment-level inference prediction."""

    emotion: str
    start_seconds: float
    end_seconds: float
    confidence: float
    probabilities: dict[str, float] | None = None


@dataclass(frozen=True)
class InferenceResult:
    """Full inference payload with frame and segment predictions."""

    schema_version: str
    segments: list[SegmentPrediction]
    frames: list[FramePrediction]


def to_legacy_emotion_segments(result: InferenceResult) -> list[EmotionSegment]:
    """Projects an :class:`InferenceResult` down to bare ``EmotionSegment`` rows.

    Pure projection — no smoothing or re-merging happens here; the legacy
    surface simply drops frame-level detail and confidences.
    """
    return [
        EmotionSegment(
            emotion=segment.emotion,
            start_seconds=segment.start_seconds,
            end_seconds=segment.end_seconds,
        )
        for segment in result.segments
    ]


__all__ = [
    "ARTIFACT_SCHEMA_VERSION",
    "OUTPUT_SCHEMA_VERSION",
    "FramePrediction",
    "InferenceResult",
    "SegmentPrediction",
    "to_legacy_emotion_segments",
]
