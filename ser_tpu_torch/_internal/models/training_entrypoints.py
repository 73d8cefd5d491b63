"""Profile training entry points.

Counterpart of ``ser_tpu/_internal/models/training_entrypoints.py``: one
entry point per profile, each running the readiness gate before its fit
(``training_orchestration.ensure_entrypoint_readiness``).
"""

from __future__ import annotations

from typing import Any

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models.fast_training import train_fast_model


def _resolve(settings: AppConfig | None) -> AppConfig:
    return settings if settings is not None else reload_settings()


def train_fast(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Fast-profile training (handcrafted features + MLP head)."""
    return train_fast_model(settings=_resolve(settings))


def train_medium_model(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Medium-profile training (XLS-R class embeddings + head)."""
    from ser_tpu_torch._internal.models.encoder_training import train_encoder_profile_model

    return train_encoder_profile_model(profile="medium", settings=_resolve(settings))


def train_accurate_model(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Accurate-profile training (Whisper-encoder embeddings + head)."""
    from ser_tpu_torch._internal.models.encoder_training import train_encoder_profile_model

    return train_encoder_profile_model(profile="accurate", settings=_resolve(settings))


def train_accurate_research_model(*, settings: AppConfig | None = None) -> dict[str, Any]:
    """Accurate-research training (emotion2vec class embeddings + head)."""
    from ser_tpu_torch._internal.models.encoder_training import train_encoder_profile_model

    return train_encoder_profile_model(
        profile="accurate-research", settings=_resolve(settings)
    )


__all__ = [
    "train_accurate_model",
    "train_accurate_research_model",
    "train_fast",
    "train_medium_model",
]
