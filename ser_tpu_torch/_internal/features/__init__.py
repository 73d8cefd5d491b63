"""Frame-level feature records of the fast profile.

Counterpart of ``ser_tpu/_internal/features/__init__.py``: the
``FeatureFrame`` record and ``extract_feature_frames``, which reads a file
and runs ``ops/features.extract_frame_features`` on the given device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from numpy.typing import NDArray

from ser_tpu_torch._internal.config.schema import AppConfig, FeatureFlags
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch.ops import features as ops_features


class FeatureFrame(NamedTuple):
    """One frame's feature vector with its temporal bounds."""

    features: NDArray[np.float64]
    start_seconds: float
    end_seconds: float


def extract_feature_frames(
    file_path: str,
    *,
    device: torch.device | str,
    frame_size_seconds: float = 3.0,
    frame_stride_seconds: float = 1.0,
    feature_flags: FeatureFlags | None = None,
    settings: AppConfig | None = None,
) -> list[FeatureFrame]:
    """Reads audio and extracts per-frame handcrafted feature vectors."""
    audio, sample_rate = read_audio_file(
        file_path, audio_read_config=settings.audio_read if settings is not None else None
    )
    feats, starts, ends = ops_features.extract_frame_features(
        audio,
        sample_rate,
        device=device,
        frame_size_seconds=frame_size_seconds,
        frame_stride_seconds=frame_stride_seconds,
        feature_flags=feature_flags,
    )
    return [
        FeatureFrame(features=feats[i].astype(np.float64), start_seconds=float(starts[i]), end_seconds=float(ends[i]))
        for i in range(feats.shape[0])
    ]


__all__ = ["FeatureFrame", "extract_feature_frames"]
