"""Deterministic frame→segment postprocessing.

Parity surface: reference ``ser/_internal/runtime/postprocessing.py`` — the
exact pipeline order and tie-break rules must be preserved bit-for-bit since
``infer()`` label/timestamp parity is the north star:

1. majority-vote label smoothing over a centered window (``:107-131``),
2. confidence hysteresis with enter/exit thresholds (``:134-167``),
3. contiguous segment assembly with fmean confidence (``:170-206``),
4. short-segment merge into the higher-confidence neighbor (``:209-252``),
5. adjacent same-label merge with duration-weighted stats (``:255-325``).

This stage runs on host floats (not on-device): it is O(frames) python over a
handful of values per second of audio, and the reference semantics (fmean,
dict-ordered Counters, in-place list surgery) are intentionally sequential.
"""

from __future__ import annotations

from collections import Counter
from collections.abc import Sequence
from dataclasses import dataclass
from statistics import fmean
from typing import Protocol

from ser_tpu_torch.runtime.schema import FramePrediction, SegmentPrediction


@dataclass(frozen=True)
class SegmentPostprocessingConfig:
    """Controls smoothing, hysteresis, and short-segment cleanup."""

    smoothing_window_frames: int = 3
    hysteresis_enter_confidence: float = 0.60
    hysteresis_exit_confidence: float = 0.45
    min_segment_duration_seconds: float = 0.40


class SupportsSegmentPostprocessingRuntime(Protocol):
    """Runtime config protocol required for postprocessing config projection."""

    @property
    def post_smoothing_window_frames(self) -> int: ...

    @property
    def post_hysteresis_enter_confidence(self) -> float: ...

    @property
    def post_hysteresis_exit_confidence(self) -> float: ...

    @property
    def post_min_segment_duration_seconds(self) -> float: ...


def build_segment_postprocessing_config(
    runtime_config: SupportsSegmentPostprocessingRuntime,
) -> SegmentPostprocessingConfig:
    """Projects one profile runtime config into a validated postprocessing config."""
    config = SegmentPostprocessingConfig(
        smoothing_window_frames=runtime_config.post_smoothing_window_frames,
        hysteresis_enter_confidence=runtime_config.post_hysteresis_enter_confidence,
        hysteresis_exit_confidence=runtime_config.post_hysteresis_exit_confidence,
        min_segment_duration_seconds=runtime_config.post_min_segment_duration_seconds,
    )
    _validate_config(config)
    return config


def _validate_config(config: SegmentPostprocessingConfig) -> None:
    """Rejects unusable control values up front.

    The VALUE constraints are the parity contract (reference
    ``postprocessing.py:90-104``); the error text is this framework's own.
    """
    checks: tuple[tuple[bool, str], ...] = (
        (
            config.smoothing_window_frames >= 1,
            f"Smoothing window needs >=1 frame, got {config.smoothing_window_frames}.",
        ),
        (
            config.hysteresis_enter_confidence >= 0.0,
            f"Hysteresis enter threshold {config.hysteresis_enter_confidence} is negative.",
        ),
        (
            config.hysteresis_exit_confidence >= 0.0,
            f"Hysteresis exit threshold {config.hysteresis_exit_confidence} is negative.",
        ),
        (
            config.hysteresis_enter_confidence >= config.hysteresis_exit_confidence,
            "Hysteresis enter threshold "
            f"({config.hysteresis_enter_confidence}) sits below the exit threshold "
            f"({config.hysteresis_exit_confidence}); segments could never open.",
        ),
        (
            config.min_segment_duration_seconds >= 0.0,
            f"Minimum segment duration {config.min_segment_duration_seconds}s is negative.",
        ),
    )
    for passed, message in checks:
        if not passed:
            raise ValueError(message)


def postprocess_frame_predictions(
    frame_predictions: Sequence[FramePrediction],
    *,
    config: SegmentPostprocessingConfig,
) -> list[SegmentPrediction]:
    """Converts frame predictions into stable segments (see module docstring)."""
    if not frame_predictions:
        return []
    _validate_config(config)
    labels = _smooth_labels(
        [frame.emotion for frame in frame_predictions], config.smoothing_window_frames
    )
    labels = _apply_hysteresis(
        labels,
        frame_predictions,
        enter_confidence=config.hysteresis_enter_confidence,
        exit_confidence=config.hysteresis_exit_confidence,
    )
    segments = _build_segments(frame_predictions, labels)
    segments = _merge_short_segments(segments, config.min_segment_duration_seconds)
    return _merge_adjacent_same_label(segments)


def _smooth_labels(labels: Sequence[str], window_size: int) -> list[str]:
    """Centered majority vote; ties keep the current label, then the previous
    output label, then the lexically smallest candidate."""
    if not labels:
        return []
    if window_size <= 1:
        return [str(label) for label in labels]
    radius = window_size // 2
    smoothed: list[str] = []
    for index, label in enumerate(labels):
        window = [str(item) for item in labels[max(0, index - radius) : index + radius + 1]]
        counts = Counter(window)
        top = max(counts.values())
        candidates = [item for item, count in counts.items() if count == top]
        if label in candidates:
            smoothed.append(str(label))
            continue
        previous = smoothed[-1] if smoothed else str(labels[0])
        smoothed.append(previous if previous in candidates else sorted(candidates)[0])
    return smoothed


def _apply_hysteresis(
    labels: Sequence[str],
    frame_predictions: Sequence[FramePrediction],
    *,
    enter_confidence: float,
    exit_confidence: float,
) -> list[str]:
    """Confidence-gated label transitions: a switch needs the candidate above
    the enter threshold and either the incumbent below the exit threshold or
    the candidate at least as confident."""
    if len(labels) != len(frame_predictions):
        raise ValueError("labels and frame_predictions must have identical length.")
    if not labels:
        return []
    if enter_confidence <= 0.0 and exit_confidence <= 0.0:
        return [str(label) for label in labels]

    incumbent = str(labels[0])
    incumbent_confidence = float(frame_predictions[0].confidence)
    stabilized = [incumbent]
    for candidate_raw, frame in zip(labels[1:], frame_predictions[1:]):
        candidate = str(candidate_raw)
        candidate_confidence = float(frame.confidence)
        if candidate == incumbent:
            incumbent_confidence = candidate_confidence
        else:
            strong_enough = candidate_confidence >= enter_confidence
            incumbent_weak = incumbent_confidence <= exit_confidence
            candidate_wins = candidate_confidence >= incumbent_confidence
            if strong_enough and (incumbent_weak or candidate_wins):
                incumbent = candidate
                incumbent_confidence = candidate_confidence
        stabilized.append(incumbent)
    return stabilized


def _build_segments(
    frame_predictions: Sequence[FramePrediction], labels: Sequence[str]
) -> list[SegmentPrediction]:
    """Contiguous equal-label runs → segments with fmean confidence."""
    if not frame_predictions:
        return []
    if len(frame_predictions) != len(labels):
        raise ValueError("frame_predictions and labels must have identical length.")

    # Run-length boundaries: positions where the label changes.
    normalized = [str(label) for label in labels]
    boundaries = [0] + [
        i for i in range(1, len(normalized)) if normalized[i] != normalized[i - 1]
    ] + [len(normalized)]

    segments: list[SegmentPrediction] = []
    for run_start, run_stop in zip(boundaries[:-1], boundaries[1:]):
        frames = frame_predictions[run_start:run_stop]
        segments.append(
            SegmentPrediction(
                emotion=normalized[run_start],
                start_seconds=float(frames[0].start_seconds),
                end_seconds=float(frames[-1].end_seconds),
                confidence=float(fmean(frame.confidence for frame in frames)),
                probabilities=_mean_probability_maps([f.probabilities for f in frames]),
            )
        )
    return segments


def _merge_short_segments(
    segments: Sequence[SegmentPrediction], min_duration_seconds: float
) -> list[SegmentPrediction]:
    """Folds sub-minimum segments into the higher-confidence neighbor."""
    if not segments:
        return []
    if min_duration_seconds <= 0.0 or len(segments) == 1:
        return list(segments)

    merged = list(segments)
    index = 0
    while index < len(merged):
        if len(merged) == 1:
            break
        current = merged[index]
        if _duration(current) >= min_duration_seconds:
            index += 1
            continue
        if index == 0:
            target_index = 1
        elif index == len(merged) - 1:
            target_index = index - 1
        else:
            target_index = (
                index - 1
                if merged[index - 1].confidence >= merged[index + 1].confidence
                else index + 1
            )
        merged_segment = _merge_into(target=merged[target_index], source=current)
        if target_index < index:
            merged[target_index] = merged_segment
            del merged[index]
            index = max(0, target_index)
        else:
            merged[target_index] = merged_segment
            del merged[index]
            index = max(0, target_index - 1)
    return merged


def _merge_adjacent_same_label(
    segments: Sequence[SegmentPrediction],
) -> list[SegmentPrediction]:
    """Collapses adjacent equal-label segments."""
    if not segments:
        return []
    normalized = [segments[0]]
    for segment in segments[1:]:
        previous = normalized[-1]
        if segment.emotion != previous.emotion:
            normalized.append(segment)
        else:
            normalized[-1] = _merge_into(target=previous, source=segment)
    return normalized


def _merge_into(*, target: SegmentPrediction, source: SegmentPrediction) -> SegmentPrediction:
    """Merges ``source`` into ``target``, keeping the target emotion and
    duration-weighting confidence/probabilities."""
    target_duration = _duration(target)
    source_duration = _duration(source)
    total = target_duration + source_duration
    if total <= 0.0:
        confidence = float(fmean([target.confidence, source.confidence]))
    else:
        confidence = (
            target.confidence * target_duration + source.confidence * source_duration
        ) / total
    probabilities = _weighted_probability_maps(
        target=target.probabilities,
        source=source.probabilities,
        target_weight=max(target_duration, 1e-12),
        source_weight=max(source_duration, 1e-12),
    )
    return SegmentPrediction(
        emotion=target.emotion,
        start_seconds=min(target.start_seconds, source.start_seconds),
        end_seconds=max(target.end_seconds, source.end_seconds),
        confidence=float(confidence),
        probabilities=probabilities,
    )


def _weighted_probability_maps(
    *,
    target: dict[str, float] | None,
    source: dict[str, float] | None,
    target_weight: float,
    source_weight: float,
) -> dict[str, float] | None:
    if target is None and source is None:
        return None
    if target is None:
        return {key: float(value) for key, value in source.items()} if source else None
    if source is None:
        return {key: float(value) for key, value in target.items()}
    total = target_weight + source_weight
    labels = sorted(set(target) | set(source))
    return {
        label: float(
            (target.get(label, 0.0) * target_weight + source.get(label, 0.0) * source_weight)
            / total
        )
        for label in labels
    }


def _mean_probability_maps(
    probabilities: Sequence[dict[str, float] | None],
) -> dict[str, float] | None:
    """Unweighted fmean aggregation over available frame probability maps."""
    valid = [item for item in probabilities if item is not None]
    if not valid:
        return None
    labels = sorted({label for item in valid for label in item})
    return {label: float(fmean(float(item.get(label, 0.0)) for item in valid)) for label in labels}


def _duration(segment: SegmentPrediction) -> float:
    return max(0.0, float(segment.end_seconds) - float(segment.start_seconds))


__all__ = [
    "SegmentPostprocessingConfig",
    "SupportsSegmentPostprocessingRuntime",
    "build_segment_postprocessing_config",
    "postprocess_frame_predictions",
]
