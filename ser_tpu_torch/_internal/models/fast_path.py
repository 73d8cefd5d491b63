"""Head predictions per pooled window: labels, confidences, probability maps.

Copied from ``ser_tpu/_internal/models/fast_path.py`` (``predict_frames`` and
the helper it calls): per-frame max-probability confidence with graceful
fallbacks when a model lacks ``predict_proba``/``classes_``.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np


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


__all__ = ["frame_confidence_and_probabilities", "predict_frames"]
