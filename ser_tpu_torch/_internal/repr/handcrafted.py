"""Handcrafted DSP feature backend (the fast profile's).

Counterpart of ``ser_tpu/_internal/repr/handcrafted.py``: the same
``backend_id`` (``handcrafted``), feature dimensionality by flags, framing
(3 s at a 1 s stride, truncated tails, empty frames skipped) and mean
pooling; all frames of a clip go through the batched program of
``ops/dsp.py`` on the backend's device.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch
from numpy.typing import NDArray

from ser_tpu_torch._internal.config.schema import FeatureFlags
from ser_tpu_torch._internal.repr.backend import (
    EncodedSequence,
    FeatureMatrix,
    FeatureVector,
    PoolingWindow,
    window_mean_pool,
)
from ser_tpu_torch.ops import features as ops_features


class HandcraftedBackend:
    """DSP feature backend over the batched feature program."""

    def __init__(
        self,
        *,
        device: torch.device | str,
        frame_size_seconds: float = 3,
        frame_stride_seconds: float = 1,
        feature_flags: FeatureFlags | None = None,
    ) -> None:
        if frame_size_seconds <= 0:
            raise ValueError("frame_size_seconds must be greater than zero.")
        if frame_stride_seconds <= 0:
            raise ValueError("frame_stride_seconds must be greater than zero.")
        self._device = torch.device(device)
        self._frame_size_seconds = frame_size_seconds
        self._frame_stride_seconds = frame_stride_seconds
        self._feature_flags = feature_flags if feature_flags is not None else FeatureFlags()

    @property
    def backend_id(self) -> str:
        return "handcrafted"

    @property
    def feature_dim(self) -> int:
        return ops_features.feature_dim(self._feature_flags)

    def encode_sequence(self, audio: NDArray[np.float32], sample_rate: int) -> EncodedSequence:
        """Frame-level handcrafted features of one clip, its frames in one batched call."""
        feats, starts, ends = ops_features.extract_frame_features(
            np.asarray(audio, dtype=np.float32),
            sample_rate,
            device=self._device,
            frame_size_seconds=self._frame_size_seconds,
            frame_stride_seconds=self._frame_stride_seconds,
            feature_flags=self._feature_flags,
        )
        return EncodedSequence(
            embeddings=feats, frame_start_seconds=starts, frame_end_seconds=ends, backend_id=self.backend_id
        )

    def pool(self, encoded: EncodedSequence, windows: Sequence[PoolingWindow]) -> FeatureMatrix:
        """Mean-pools the encoded frames per window (float64 accumulation)."""
        return window_mean_pool(encoded, windows)

    def extract_vector(self, audio: NDArray[np.float32], sample_rate: int) -> FeatureVector:
        """Whole-clip feature vector (the fast profile's training input)."""
        return ops_features.extract_feature_from_signal(
            np.asarray(audio, dtype=np.float32), sample_rate, device=self._device, feature_flags=self._feature_flags
        )


__all__ = ["HandcraftedBackend"]
