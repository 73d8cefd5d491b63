"""Emotion model facade, inference half: load the fast head, predict a file.

Counterpart of the inference half of ``ser_tpu/_internal/models/
emotion_model.py`` (``load_model``, ``predict_emotions_detailed`` and the
fast profile's framing constants). The head and the feature program run on
the settings' torch device (the card unless ``SER_TORCH_DEVICE=cpu``).
``train_model`` waits for the training slice (``ROADMAP.md``).
"""

from __future__ import annotations


from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.features import extract_feature_frames
from ser_tpu_torch._internal.models import artifacts, fast_path
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.runtime.schema import InferenceResult

logger = get_logger(__name__)

#: The fast profile's encode framing.
FAST_FRAME_SIZE_SECONDS = 3.0
FAST_FRAME_STRIDE_SECONDS = 1.0


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


__all__ = ["FAST_FRAME_SIZE_SECONDS", "FAST_FRAME_STRIDE_SECONDS", "load_model", "predict_emotions_detailed"]
