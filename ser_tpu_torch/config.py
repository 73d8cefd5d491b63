"""Public configuration facade of the PyTorch port (``ser_tpu/config.py``'s names)."""

from ser_tpu_torch._internal.config.bootstrap import (
    build_settings,
    get_settings,
    reload_settings,
    settings_override,
)
from ser_tpu_torch._internal.config.schema import (
    APP_NAME, AcceleratorRuntimeConfig, AccurateResearchRuntimeConfig, AccurateRuntimeConfig,
    AppConfig, ArtifactProfileName, AudioReadConfig, DataLoaderConfig, DatasetConfig,
    FastRuntimeConfig, FeatureFlags, FeatureRuntimeBackendOverride, FeatureRuntimePolicyConfig,
    MediumRuntimeConfig, MediumTrainingConfig, MeshConfig, ModelsConfig, NeuralNetConfig,
    OntologyConfig, ProfileRuntimeConfig, QualityGateConfig, RuntimeFlags, SchemaConfig, TimelineConfig,
    TorchRuntimeConfig, TrainingConfig, TranscriptionConfig, WhisperModelConfig,
    default_profile_model_id, profile_artifact_file_names,
)

__all__ = [
    "APP_NAME", "AcceleratorRuntimeConfig", "AccurateResearchRuntimeConfig", "AccurateRuntimeConfig",
    "AppConfig", "ArtifactProfileName", "AudioReadConfig", "DataLoaderConfig",
    "DatasetConfig", "FastRuntimeConfig", "FeatureFlags", "FeatureRuntimeBackendOverride",
    "FeatureRuntimePolicyConfig", "MediumRuntimeConfig", "MediumTrainingConfig", "MeshConfig",
    "ModelsConfig", "NeuralNetConfig", "OntologyConfig", "ProfileRuntimeConfig", "QualityGateConfig",
    "RuntimeFlags", "SchemaConfig", "TimelineConfig", "TorchRuntimeConfig",
    "TrainingConfig", "TranscriptionConfig", "WhisperModelConfig", "build_settings",
    "default_profile_model_id", "get_settings", "profile_artifact_file_names", "reload_settings",
    "settings_override",
]
