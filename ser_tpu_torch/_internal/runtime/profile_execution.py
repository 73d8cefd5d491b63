"""Pure per-profile execution pass: encode → window → pool → predict → postprocess.

Copied from ``ser_tpu/_internal/runtime/profile_execution.py``: mean/std
(every windowed profile's strategy) or mean pooling, each on the device when
the encode left the frames there (``SER_DEVICE_POOLING=1``). The profile
supplies the backend and the
postprocessing config. Under a profiler the pooling is the span ``ser.pool``,
the head and the postprocessing ``ser.classify`` (``utils/profiling.py``).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, Literal

import numpy as np

from ser_tpu_torch._internal.models.fast_path import predict_frames
from ser_tpu_torch._internal.pool import mean_std_pool, temporal_pooling_windows
from ser_tpu_torch._internal.pool.device_pool import device_mean_std_pool, is_device_embeddings
from ser_tpu_torch._internal.repr import EncodedSequence, FeatureBackend, PoolingWindow, overlap_frame_mask
from ser_tpu_torch._internal.runtime.postprocessing import (
    SegmentPostprocessingConfig,
    postprocess_frame_predictions,
)
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch._internal.utils.profiling import span
from ser_tpu_torch.runtime.schema import FramePrediction, InferenceResult

logger = get_logger(__name__)

type PoolingStrategy = Literal["mean", "mean_std"]


def _mean_pool(encoded: EncodedSequence, windows: list[PoolingWindow]) -> np.ndarray:
    if is_device_embeddings(encoded.embeddings):
        # The mean half of the device pool is exactly the mean pooling.
        pooled = device_mean_std_pool(encoded, windows)
        return pooled[:, : pooled.shape[1] // 2]
    rows = []
    for window in windows:
        mask = overlap_frame_mask(encoded, window)
        rows.append(np.asarray(encoded.embeddings[mask], dtype=np.float64).mean(axis=0))
    return np.vstack(rows)


def run_windowed_inference_once(
    *,
    audio: np.ndarray,
    sample_rate: int,
    backend: FeatureBackend,
    model: Any,
    pool_window_size_seconds: float,
    pool_window_stride_seconds: float,
    postprocessing_config: SegmentPostprocessingConfig,
    pooling_strategy: PoolingStrategy = "mean_std",
    output_schema_version: str,
    expected_feature_size: int | None = None,
    encode_fn: Callable[[np.ndarray, int], EncodedSequence] | None = None,
) -> InferenceResult:
    """One deterministic windowed inference pass for transformer profiles.

    ``encode_fn`` replaces ``backend.encode_sequence`` (batch inference hands
    in a clip it encoded in a batch with others).
    """
    encode = encode_fn if encode_fn is not None else backend.encode_sequence
    encoded = encode(audio, sample_rate)
    with span("ser.pool"):
        windows = temporal_pooling_windows(
            encoded,
            window_size_seconds=pool_window_size_seconds,
            window_stride_seconds=pool_window_stride_seconds,
        )
        features = mean_std_pool(encoded, windows) if pooling_strategy == "mean_std" else _mean_pool(encoded, windows)

    if expected_feature_size is not None and features.shape[1] != expected_feature_size:
        raise ValueError(
            "Pooled feature size mismatch for loaded model. "
            f"Expected {expected_feature_size}, got {features.shape[1]}."
        )

    with span("ser.classify"):
        predicted, confidences, probabilities = predict_frames(
            model, features, len(windows), logger=logger
        )
        frames = [
            FramePrediction(
                start_seconds=float(window.start_seconds),
                end_seconds=float(window.end_seconds),
                emotion=predicted[i],
                confidence=confidences[i],
                probabilities=probabilities[i],
            )
            for i, window in enumerate(windows)
        ]
        segments = postprocess_frame_predictions(frames, config=postprocessing_config)
        return InferenceResult(
            schema_version=output_schema_version, segments=segments, frames=frames
        )


__all__ = ["PoolingStrategy", "run_windowed_inference_once"]
