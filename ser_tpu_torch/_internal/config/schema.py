"""Frozen settings snapshot of the PyTorch port (the fields its path reads).

Counterpart of ``ser_tpu/_internal/config/schema.py``. Field names, defaults
and the platform cache/data directories are the JAX package's, so one
environment configures both packages alike. Only the sections the four
profiles' inference paths, their transcript lane, the restricted-backend
gate, the data layer and the training entry points read are here; the full
settings builder is later work (``ROADMAP.md``).
"""

from __future__ import annotations

import os
import sys
from collections.abc import Mapping
from dataclasses import dataclass, field
from pathlib import Path
from typing import Literal

from ser_tpu_torch._internal.config.artifact_naming import FAST_MODEL_FILE_NAME, FAST_TRAINING_REPORT_FILE_NAME
from ser_tpu_torch._internal.data.ravdess import RAVDESS_EMOTIONS
from ser_tpu_torch.profiles import ProfileName, ProfileRuntimeDefaults, require_ported
from ser_tpu_torch.runtime.schema import OUTPUT_SCHEMA_VERSION

APP_NAME = "ser"
#: The fast profile's head artifact.
DEFAULT_FAST_MODEL_FILE_NAME = FAST_MODEL_FILE_NAME


def _platform_cache_base_dir() -> Path:
    if sys.platform == "win32":
        return Path(os.getenv("LOCALAPPDATA", str(Path.home() / "AppData/Local")))
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Caches"
    return Path(os.getenv("XDG_CACHE_HOME", str(Path.home() / ".cache")))


def _platform_data_base_dir() -> Path:
    if sys.platform == "win32":
        return Path(os.getenv("APPDATA", str(Path.home() / "AppData/Roaming")))
    if sys.platform == "darwin":
        return Path.home() / "Library" / "Application Support"
    return Path(os.getenv("XDG_DATA_HOME", str(Path.home() / ".local/share")))


def default_cache_root() -> Path:
    return _platform_cache_base_dir() / APP_NAME


def default_data_root() -> Path:
    return _platform_data_base_dir() / APP_NAME


def default_profile_model_id(profile: ProfileName) -> str | None:
    """The catalog's default model id for one profile (None for the fast profile)."""
    return require_ported(profile).default_model_id


@dataclass(frozen=True)
class FeatureFlags:
    """Handcrafted feature-group toggles (the fast profile's 193 features with all on)."""

    mfcc: bool = True
    chroma: bool = True
    mel: bool = True
    contrast: bool = True
    tonnetz: bool = True


@dataclass(frozen=True)
class NeuralNetConfig:
    """The MLP head's hyperparameters (``TorchMLPClassifier.from_config``)."""

    alpha: float = 0.01
    batch_size: int | Literal["auto"] = 256
    epsilon: float = 1e-08
    hidden_layer_sizes: tuple[int, ...] = (300,)
    #: Read by nothing in the fit (constant Adam steps, as in the JAX package); kept so that both
    #: packages' settings digests (``training_readiness._settings_digest``) agree.
    learning_rate: Literal["constant", "invscaling", "adaptive"] = "adaptive"
    max_iter: int = 500
    random_state: int = 42


@dataclass(frozen=True)
class DatasetConfig:
    """Where the training corpus lives, and the manifests, recipe and registry that describe it."""

    folder: Path = field(default_factory=lambda: default_data_root() / "dataset" / "ravdess")
    subfolder_prefix: str = "Actor_*"
    extension: str = "*.wav"
    manifest_paths: tuple[Path, ...] = ()
    recipe: str | None = None
    strict_audit: bool = False
    #: Where the dataset registry lives instead of beside the models folder (None: there).
    registry_root: Path | None = None

    @property
    def glob_pattern(self) -> str:
        """The glob of the corpus's audio files."""
        return str(self.folder / self.subfolder_prefix / self.extension)


@dataclass(frozen=True)
class DataLoaderConfig:
    """Decode parallelism and the failure and quarantine budgets of dataset loading."""

    max_workers: int = 8
    max_failed_file_ratio: float = 0.01
    max_failed_files: int = 25
    max_failed_file_ratio_per_corpus: float = 0.01
    max_failed_file_ratio_per_class: float = 0.01
    max_failures_per_reason: int = 10
    min_remaining_per_class_split: int = 1
    strict_quarantine: bool = False


@dataclass(frozen=True)
class TrainingConfig:
    """The train/dev/test split of model training."""

    test_size: float = 0.25
    dev_size: float = 0.10
    random_state: int = 42
    stratify_split: bool = True


@dataclass(frozen=True)
class MediumTrainingConfig:
    """Noise controls of the encoder profiles' training windows (``noise_controls.py``)."""

    min_window_std: float = 0.0
    max_windows_per_clip: int = 0


@dataclass(frozen=True)
class OntologyConfig:
    """The label ontology: empty ``allowed_labels`` means the emotion map's values."""

    ontology_id: str = "default_v1"
    allowed_labels: tuple[str, ...] = ()
    unknown_label_policy: str = "drop"
    other_label: str = "other"


@dataclass(frozen=True)
class AudioReadConfig:
    """Retry policy for audio reads."""

    max_retries: int = 3
    retry_delay_seconds: float = 1.0


@dataclass(frozen=True)
class WhisperModelConfig:
    """Transcription model selection and storage location.

    ``name`` is empty unless selected (``WHISPER_MODEL``): the profile's
    catalog default then applies at transcription time.
    """

    name: str = ""
    relative_path: Path = Path("OpenAI/whisper")


@dataclass(frozen=True)
class ModelsConfig:
    """Where trained artifacts and model caches live."""

    folder: Path = field(default_factory=lambda: default_data_root() / "models")
    model_cache_dir: Path = field(default_factory=lambda: default_cache_root() / "model-cache")
    medium_model_id: str = field(default_factory=lambda: default_profile_model_id("medium"))
    accurate_model_id: str = field(default_factory=lambda: default_profile_model_id("accurate"))
    accurate_research_model_id: str = field(
        default_factory=lambda: default_profile_model_id("accurate-research")
    )
    model_file_name: str = DEFAULT_FAST_MODEL_FILE_NAME
    whisper_model: WhisperModelConfig = field(default_factory=WhisperModelConfig)

    @property
    def model_file(self) -> Path:
        """The fast profile's head artifact."""
        return self.folder / self.model_file_name

    @property
    def training_report_file(self) -> Path:
        """The fast profile's training report."""
        return self.folder / FAST_TRAINING_REPORT_FILE_NAME

    @property
    def huggingface_cache_root(self) -> Path:
        return self.model_cache_dir / "huggingface"

    @property
    def modelscope_cache_root(self) -> Path:
        """ModelScope hub cache, where FunASR checkpoints (the emotion2vec family) are staged."""
        return self.model_cache_dir / "modelscope" / "hub"

    @property
    def whisper_download_root(self) -> Path:
        """Where staged HF-format Whisper checkpoints are looked up, one folder per model name."""
        return self.model_cache_dir / self.whisper_model.relative_path


@dataclass(frozen=True)
class TranscriptionConfig:
    """Runtime controls of the transcript lane (the JAX package's fields and defaults).

    The defaults of ``backend_id``, ``use_demucs`` and ``use_vad`` are the
    catalog's process-wide ones; a profile request projects that profile's
    transcription defaults over them (``apply_cli_profile_override``).
    """

    backend_id: str = "jax_whisper"
    use_demucs: bool = False
    use_vad: bool = True
    decode_strategy: str = "greedy"
    beam_size: int = 5
    length_penalty: float = 1.0
    hbm_admission_control_enabled: bool = True
    hbm_hard_oom_shortcut_enabled: bool = True
    hbm_admission_min_headroom_mb: float = 256.0
    hbm_admission_safety_margin_mb: float = 256.0
    calibration_overrides_enabled: bool = True
    calibration_min_confidence: str = "high"
    calibration_report_max_age_hours: float = 168.0
    calibration_report_path: Path | None = None
    separation_model_path: Path | None = None
    #: Honoured on the CPU only (``_internal/transcript/process_isolation.py``).
    process_isolation: bool = False
    isolation_timeout_seconds: float = 600.0


@dataclass(frozen=True)
class RuntimeFlags:
    """Profile enable flags and the restricted-backend gate."""

    profile_pipeline: bool = False
    medium_profile: bool = False
    accurate_profile: bool = False
    accurate_research_profile: bool = False
    restricted_backends: bool = False
    #: ``SER_ALLOWED_RESTRICTED_BACKENDS``: an env allowlist honoured in place of recorded consent.
    allowed_restricted_backends: tuple[str, ...] = ()


@dataclass(frozen=True)
class SchemaConfig:
    """Output schema version."""

    output_schema_version: str = OUTPUT_SCHEMA_VERSION


@dataclass(frozen=True)
class TorchRuntimeConfig:
    """Device and dtype selectors (``SER_TORCH_DEVICE`` / ``SER_TORCH_DTYPE``).

    ``"auto"`` device means the CUDA card and raises where there is none; the
    CPU runs only when asked for by name.
    """

    device: str = "auto"
    dtype: str = "auto"


@dataclass(frozen=True)
class AppConfig:
    """The port's settings snapshot."""

    emotions: Mapping[str, str] = field(default_factory=lambda: dict(RAVDESS_EMOTIONS))
    nn: NeuralNetConfig = field(default_factory=NeuralNetConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    data_loader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    medium_training: MediumTrainingConfig = field(default_factory=MediumTrainingConfig)
    ontology: OntologyConfig = field(default_factory=OntologyConfig)
    audio_read: AudioReadConfig = field(default_factory=AudioReadConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    runtime_flags: RuntimeFlags = field(default_factory=RuntimeFlags)
    feature_flags: FeatureFlags = field(default_factory=FeatureFlags)
    fast_runtime: ProfileRuntimeDefaults = field(default_factory=lambda: require_ported("fast").runtime_defaults)
    medium_runtime: ProfileRuntimeDefaults = field(default_factory=lambda: require_ported("medium").runtime_defaults)
    accurate_runtime: ProfileRuntimeDefaults = field(
        default_factory=lambda: require_ported("accurate").runtime_defaults
    )
    accurate_research_runtime: ProfileRuntimeDefaults = field(
        default_factory=lambda: require_ported("accurate-research").runtime_defaults
    )
    schema: SchemaConfig = field(default_factory=SchemaConfig)
    torch_runtime: TorchRuntimeConfig = field(default_factory=TorchRuntimeConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    tmp_folder: Path = field(default_factory=lambda: default_cache_root() / "tmp")
    default_language: str = "en"

    def profile_runtime(self, profile: ProfileName) -> ProfileRuntimeDefaults:
        require_ported(profile)
        return {
            "fast": self.fast_runtime,
            "medium": self.medium_runtime,
            "accurate": self.accurate_runtime,
            "accurate-research": self.accurate_research_runtime,
        }[profile]

    def profile_model_id(self, profile: ProfileName) -> str | None:
        """The model id the profile's backend loads (the settings override the catalog's; None for fast)."""
        require_ported(profile)
        return {
            "fast": None,
            "medium": self.models.medium_model_id,
            "accurate": self.models.accurate_model_id,
            "accurate-research": self.models.accurate_research_model_id,
        }[profile]


__all__ = [
    "AppConfig",
    "AudioReadConfig",
    "DEFAULT_FAST_MODEL_FILE_NAME",
    "DataLoaderConfig",
    "DatasetConfig",
    "FeatureFlags",
    "MediumTrainingConfig",
    "ModelsConfig",
    "NeuralNetConfig",
    "OntologyConfig",
    "RuntimeFlags",
    "SchemaConfig",
    "TorchRuntimeConfig",
    "TrainingConfig",
    "TranscriptionConfig",
    "WhisperModelConfig",
    "default_cache_root",
    "default_data_root",
    "default_profile_model_id",
]
