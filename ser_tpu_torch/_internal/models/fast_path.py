"""Head predictions per frame, and the fast profile's inference pass.

Copied from ``ser_tpu/_internal/models/fast_path.py``: per-frame
max-probability confidence with graceful fallbacks when a model lacks
``predict_proba``/``classes_`` (``predict_frames``, which the windowed
profiles share), the mean of the frames' probability maps, the merge of
adjacent equal-label frames into segments, and the fast profile's pass from
feature frames to an ``InferenceResult``.
"""

from __future__ import annotations

import logging
from collections.abc import Callable, Sequence
from statistics import fmean
from typing import Any

import numpy as np

from ser_tpu_torch._internal.features import FeatureFrame
from ser_tpu_torch.runtime.schema import FramePrediction, InferenceResult, SegmentPrediction


def frame_confidence_and_probabilities(
    model: Any,
    feature_matrix: np.ndarray,
    frame_count: int,
    *,
    logger: logging.Logger,
) -> tuple[list[float], list[dict[str, float] | None]]:
    """Per-frame max-probability confidence + full class probability maps.

    Falls back to confidence=1.0 / probabilities=None whenever the model lacks
    ``predict_proba``/``classes_`` or returns inconsistent shapes.
    """
    fallback = ([1.0] * frame_count, [None] * frame_count)

    predict_proba = getattr(model, "predict_proba", None)
    if not callable(predict_proba):
        logger.warning("Model exposes no predict_proba; using confidence=1.0 fallback.")
        return fallback

    classes = getattr(model, "classes_", None)
    if isinstance(classes, np.ndarray):
        class_labels = [str(item) for item in classes.tolist()]
    elif isinstance(classes, (list, tuple)):
        class_labels = [str(item) for item in classes]
    else:
        logger.warning("Model predict_proba path missing classes_; using fallback.")
        return fallback

    raw = np.asarray(predict_proba(feature_matrix), dtype=np.float64)
    if raw.ndim != 2 or raw.shape[0] != frame_count or raw.shape[1] != len(class_labels):
        logger.warning("Unexpected predict_proba output shape %s; using fallback.", raw.shape)
        return fallback

    confidences = [float(np.max(row)) for row in raw]
    probabilities: list[dict[str, float] | None] = [
        {class_labels[i]: float(row[i]) for i in range(len(class_labels))} for row in raw
    ]
    return confidences, probabilities


def predict_frames(
    model: Any,
    feature_matrix: np.ndarray,
    frame_count: int,
    *,
    logger: logging.Logger,
) -> tuple[list[str], list[float], list[dict[str, float] | None]]:
    """Labels + confidences + probability maps from ONE model forward.

    ``predict`` followed by ``predict_proba`` runs two identical forwards
    (each a device dispatch on the JAX head — ~30 ms over a remote link);
    for softmax classifiers the label is the argmax of the probabilities,
    so one ``predict_proba`` call serves both. Models without a usable
    probability path fall back to ``predict`` + unit confidence.
    """
    confidences, probabilities = frame_confidence_and_probabilities(
        model=model,
        feature_matrix=feature_matrix,
        frame_count=frame_count,
        logger=logger,
    )
    if probabilities and all(row is not None for row in probabilities):
        predicted = [
            max(row, key=row.get)  # type: ignore[arg-type]
            for row in probabilities
        ]
        return predicted, confidences, probabilities
    predicted = [str(item) for item in model.predict(feature_matrix)]
    return predicted, confidences, probabilities


def aggregate_probabilities(probabilities: list[dict[str, float] | None]) -> dict[str, float] | None:
    """fmean over frames when every frame supplies the same full label set."""
    if not probabilities or any(item is None for item in probabilities):
        return None
    labels = list(probabilities[0].keys())
    if any(set(item.keys()) != set(labels) for item in probabilities[1:]):
        return None
    return {label: float(fmean(item[label] for item in probabilities)) for label in labels}


def segment_predictions(frame_predictions: list[FramePrediction]) -> list[SegmentPrediction]:
    """Merges adjacent equal-label frames into segment predictions."""
    if not frame_predictions:
        return []
    segments: list[SegmentPrediction] = []
    run: list[FramePrediction] = [frame_predictions[0]]
    for frame in frame_predictions[1:]:
        if frame.emotion == run[-1].emotion:
            run.append(frame)
            continue
        segments.append(_segment_from_run(run))
        run = [frame]
    segments.append(_segment_from_run(run))
    return segments


def _segment_from_run(run: list[FramePrediction]) -> SegmentPrediction:
    return SegmentPrediction(
        emotion=run[0].emotion,
        start_seconds=run[0].start_seconds,
        end_seconds=run[-1].end_seconds,
        confidence=float(fmean(frame.confidence for frame in run)),
        probabilities=aggregate_probabilities([frame.probabilities for frame in run]),
    )


def predict_emotions_detailed_with_model(
    file: str,
    *,
    model: Any,
    expected_feature_size: int | None,
    output_schema_version: str,
    extract_feature_frames_fn: Callable[[str], Sequence[FeatureFrame]],
    logger: logging.Logger,
) -> InferenceResult:
    """Fast-path inference of one file with a loaded head: frames, labels, merged segments."""
    feature_frames = list(extract_feature_frames_fn(file))
    if not feature_frames:
        logger.warning("No features extracted for file %s.", file)
        return InferenceResult(schema_version=output_schema_version, segments=[], frames=[])

    vectors = [frame.features for frame in feature_frames]
    if expected_feature_size is not None:
        bad_sizes = {v.shape[0] for v in vectors if v.shape[0] != expected_feature_size}
        if bad_sizes:
            raise ValueError(
                "Feature vector size mismatch for loaded model. "
                f"Expected {expected_feature_size}, got {sorted(bad_sizes)}."
            )

    matrix = np.asarray(vectors, dtype=np.float64)
    predicted, confidences, probabilities = predict_frames(model, matrix, len(feature_frames), logger=logger)
    if len(predicted) != len(feature_frames):
        raise RuntimeError(
            "Frame/prediction length mismatch. "
            f"Got {len(feature_frames)} frames and {len(predicted)} predictions."
        )
    frames = [
        FramePrediction(
            start_seconds=frame.start_seconds,
            end_seconds=frame.end_seconds,
            emotion=predicted[i],
            confidence=confidences[i],
            probabilities=probabilities[i],
        )
        for i, frame in enumerate(feature_frames)
    ]
    return InferenceResult(schema_version=output_schema_version, segments=segment_predictions(frames), frames=frames)


__all__ = [
    "aggregate_probabilities",
    "frame_confidence_and_probabilities",
    "predict_emotions_detailed_with_model",
    "predict_frames",
    "segment_predictions",
]
