"""Emotion model facade: train the fast head, load it, predict a file.

Counterpart of ``ser_tpu/_internal/models/emotion_model.py`` (``train_model``,
``load_model``, ``predict_emotions_detailed``, the legacy segment-only
``predict_emotions`` and the per-profile framing constants). The head and the feature program run on the settings' torch
device (the card unless ``SER_TORCH_DEVICE=cpu``).
"""

from __future__ import annotations

from typing import Any

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.features import extract_feature_frames
from ser_tpu_torch._internal.models import artifacts, fast_path
from ser_tpu_torch._internal.models.fast_training import train_fast_model
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.domain import EmotionSegment
from ser_tpu_torch.runtime.schema import InferenceResult, to_legacy_emotion_segments

logger = get_logger(__name__)

#: Per-profile encode framing.
FAST_FRAME_SIZE_SECONDS = 3.0
FAST_FRAME_STRIDE_SECONDS = 1.0
MEDIUM_FRAME_SIZE_SECONDS = 1.0
MEDIUM_FRAME_STRIDE_SECONDS = 1.0
MEDIUM_POOLING_STRATEGY = "mean_std"


def train_model(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Trains the fast profile's head (the legacy ``--train`` path); returns its report."""
    return train_fast_model(settings=settings if settings is not None else reload_settings())


def load_model(*, settings: AppConfig | None = None, profile: str = "fast") -> artifacts.LoadedModel:
    """Loads the persisted head artifact (``settings.models.model_file``) with its compatibility checks."""
    settings = settings if settings is not None else reload_settings()
    return artifacts.load_model_artifact(
        settings.models.model_file, expected_profile=profile, device=resolve_device(settings.torch_runtime.device)
    )


def predict_emotions_detailed(
    file: str,
    *,
    settings: AppConfig | None = None,
    loaded: artifacts.LoadedModel | None = None,
) -> InferenceResult:
    """Fast-path detailed inference over one audio file."""
    settings = settings if settings is not None else reload_settings()
    if loaded is None:
        loaded = load_model(settings=settings, profile="fast")
    device = resolve_device(settings.torch_runtime.device)

    def extract(path: str):
        return extract_feature_frames(
            path,
            device=device,
            frame_size_seconds=FAST_FRAME_SIZE_SECONDS,
            frame_stride_seconds=FAST_FRAME_STRIDE_SECONDS,
            feature_flags=settings.feature_flags,
            settings=settings,
        )

    return fast_path.predict_emotions_detailed_with_model(
        file,
        model=loaded.model,
        expected_feature_size=loaded.expected_feature_size,
        output_schema_version=settings.schema.output_schema_version,
        extract_feature_frames_fn=extract,
        logger=logger,
    )


def predict_emotions(
    file: str,
    *,
    settings: AppConfig | None = None,
    loaded: artifacts.LoadedModel | None = None,
) -> list[EmotionSegment]:
    """Legacy segment-only inference."""
    return to_legacy_emotion_segments(predict_emotions_detailed(file, settings=settings, loaded=loaded))


__all__ = [
    "FAST_FRAME_SIZE_SECONDS",
    "FAST_FRAME_STRIDE_SECONDS",
    "MEDIUM_FRAME_SIZE_SECONDS",
    "MEDIUM_FRAME_STRIDE_SECONDS",
    "MEDIUM_POOLING_STRATEGY",
    "load_model",
    "predict_emotions",
    "predict_emotions_detailed",
    "train_model",
]
