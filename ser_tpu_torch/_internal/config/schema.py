"""Frozen settings snapshot of the PyTorch port.

Counterpart of ``ser_tpu/_internal/config/schema.py``: every section and
field of the JAX package's ``AppConfig``, with its names and defaults and the
same platform cache/data directories, so one environment configures both
packages alike (``settings_inputs.py`` and ``settings_builder.py`` read it).
The port's own: ``TorchRuntimeConfig`` selects the torch device and dtype
(``SER_TORCH_DEVICE``, ``SER_TORCH_DTYPE``; no MPS fallback), and
``AppConfig.emotions`` defaults to the RAVDESS map.
"""

from __future__ import annotations

import os
import sys
from collections.abc import Mapping
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Literal

from ser_tpu_torch._internal.config import artifact_naming
from ser_tpu_torch._internal.data.ravdess import RAVDESS_EMOTIONS
from ser_tpu_torch.profiles import ProfileName, require_ported
from ser_tpu_torch.runtime.schema import OUTPUT_SCHEMA_VERSION

APP_NAME = "ser"
DEFAULT_FAST_MODEL_FILE_NAME = artifact_naming.FAST_MODEL_FILE_NAME
DEFAULT_FAST_SECURE_MODEL_FILE_NAME = artifact_naming.FAST_SECURE_MODEL_FILE_NAME
DEFAULT_FAST_TRAINING_REPORT_FILE_NAME = artifact_naming.FAST_TRAINING_REPORT_FILE_NAME

type ArtifactProfileName = ProfileName


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


def default_profile_model_id(profile: ArtifactProfileName) -> str:
    """The catalog's default model id for one model-backed profile (the fast profile has none)."""
    model_id = require_ported(profile).default_model_id
    if isinstance(model_id, str) and model_id.strip():
        return model_id.strip()
    raise RuntimeError(f"Profile {profile!r} does not define a default model id.")


def profile_artifact_file_names(
    *,
    profile: ArtifactProfileName,
    medium_model_id: str | None = None,
    accurate_model_id: str | None = None,
    accurate_research_model_id: str | None = None,
) -> tuple[str, str, str]:
    """``(model, secure_model, training_report)`` filenames for one profile (catalog model ids by default)."""
    if profile == "fast":
        return artifact_naming.profile_artifact_file_names(profile="fast", model_id=None)
    model_id = {
        "medium": medium_model_id,
        "accurate": accurate_model_id,
        "accurate-research": accurate_research_model_id,
    }[profile]
    return artifact_naming.profile_artifact_file_names(
        profile=profile, model_id=model_id or default_profile_model_id(profile)
    )


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
    num_cores: int = 1
    model_file_name: str = DEFAULT_FAST_MODEL_FILE_NAME
    secure_model_file_name: str = DEFAULT_FAST_SECURE_MODEL_FILE_NAME
    training_report_file_name: str = DEFAULT_FAST_TRAINING_REPORT_FILE_NAME
    whisper_model: WhisperModelConfig = field(default_factory=WhisperModelConfig)

    @property
    def model_file(self) -> Path:
        """The fast profile's head artifact."""
        return self.folder / self.model_file_name

    @property
    def secure_model_file(self) -> Path:
        return self.folder / self.secure_model_file_name

    @property
    def training_report_file(self) -> Path:
        """The fast profile's training report."""
        return self.folder / self.training_report_file_name

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
class TimelineConfig:
    """Where the timeline's CSV and subtitle exports go (``SER_TRANSCRIPTS_FOLDER``)."""

    folder: Path = field(default_factory=lambda: default_data_root() / "transcripts")


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
    new_output_schema: bool = False


@dataclass(frozen=True)
class ProfileRuntimeConfig:
    """Execution budgets and postprocessing controls for one runtime profile.

    The boundaries' retry policy reads the budgets (``_internal/runtime/
    policy.py``); the windowed profiles read the pooling and postprocessing
    fields.
    """

    timeout_seconds: float
    max_timeout_retries: int
    max_transient_retries: int
    retry_backoff_seconds: float
    pool_window_size_seconds: float
    pool_window_stride_seconds: float
    post_smoothing_window_frames: int
    post_hysteresis_enter_confidence: float
    post_hysteresis_exit_confidence: float
    post_min_segment_duration_seconds: float
    process_isolation: bool


def _make_profile_runtime_config_class(profile: ProfileName, class_name: str):
    """A ``ProfileRuntimeConfig`` subclass whose field defaults are the catalog's for ``profile``."""
    namespace = {
        "__doc__": f"Execution budgets and retry controls for the {profile} profile.",
        "__annotations__": {f.name: f.type for f in fields(ProfileRuntimeConfig)},
        "__module__": __name__,
    }
    for f in fields(ProfileRuntimeConfig):
        namespace[f.name] = field(
            default_factory=(lambda n=f.name: getattr(require_ported(profile).runtime_defaults, n))
        )
    return dataclass(frozen=True)(type(class_name, (ProfileRuntimeConfig,), namespace))


FastRuntimeConfig = _make_profile_runtime_config_class("fast", "FastRuntimeConfig")
MediumRuntimeConfig = _make_profile_runtime_config_class("medium", "MediumRuntimeConfig")
AccurateRuntimeConfig = _make_profile_runtime_config_class("accurate", "AccurateRuntimeConfig")
AccurateResearchRuntimeConfig = _make_profile_runtime_config_class(
    "accurate-research", "AccurateResearchRuntimeConfig"
)


@dataclass(frozen=True)
class QualityGateConfig:
    """Promotion thresholds of the fast-versus-candidate quality gate."""

    min_uar_delta: float = 0.0025
    min_macro_f1_delta: float = 0.0025
    max_medium_segments_per_minute: float = 25.0
    min_medium_median_segment_duration_seconds: float = 2.5


@dataclass(frozen=True)
class SchemaConfig:
    """Output and artifact schema versions."""

    output_schema_version: str = OUTPUT_SCHEMA_VERSION
    artifact_schema_version: str = "v2"


@dataclass(frozen=True)
class TorchRuntimeConfig:
    """Device and dtype selectors (``SER_TORCH_DEVICE`` / ``SER_TORCH_DTYPE``).

    ``"auto"`` device means the CUDA card and raises where there is none; the
    CPU runs only when asked for by name.
    """

    device: str = "auto"
    dtype: str = "auto"


#: The JAX package's alias of the accelerator selector.
AcceleratorRuntimeConfig = TorchRuntimeConfig


@dataclass(frozen=True)
class FeatureRuntimeBackendOverride:
    """Backend-scoped device/dtype override used by feature policy resolution."""

    device: str | None = None
    dtype: str | None = None


@dataclass(frozen=True)
class FeatureRuntimePolicyConfig:
    """Optional backend-specific runtime selector overrides."""

    backend_overrides: tuple[tuple[str, FeatureRuntimeBackendOverride], ...] = ()

    def for_backend(self, backend_id: str) -> FeatureRuntimeBackendOverride | None:
        """Returns one backend override when present."""
        normalized = backend_id.strip().lower()
        if not normalized:
            return None
        for candidate, override in self.backend_overrides:
            if candidate == normalized:
                return override
        return None


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) mesh layout (``SER_MESH_DATA_AXIS_SIZE`` / ``SER_MESH_MODEL_AXIS_SIZE``).

    An axis size of 0 means "infer from the process count": the data axis
    absorbs what the model axis leaves.
    """

    data_axis_size: int = 0
    model_axis_size: int = 1
    axis_names: tuple[str, str] = ("data", "model")


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
    fast_runtime: FastRuntimeConfig = field(default_factory=FastRuntimeConfig)
    medium_runtime: MediumRuntimeConfig = field(default_factory=MediumRuntimeConfig)
    accurate_runtime: AccurateRuntimeConfig = field(default_factory=AccurateRuntimeConfig)
    accurate_research_runtime: AccurateResearchRuntimeConfig = field(
        default_factory=AccurateResearchRuntimeConfig
    )
    quality_gate: QualityGateConfig = field(default_factory=QualityGateConfig)
    schema: SchemaConfig = field(default_factory=SchemaConfig)
    torch_runtime: TorchRuntimeConfig = field(default_factory=TorchRuntimeConfig)
    feature_runtime_policy: FeatureRuntimePolicyConfig = field(default_factory=FeatureRuntimePolicyConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    timeline: TimelineConfig = field(default_factory=TimelineConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    tmp_folder: Path = field(default_factory=lambda: default_cache_root() / "tmp")
    default_language: str = "en"

    def profile_runtime(self, profile: ProfileName) -> ProfileRuntimeConfig:
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
    "APP_NAME",
    "DEFAULT_FAST_MODEL_FILE_NAME",
    "DEFAULT_FAST_SECURE_MODEL_FILE_NAME",
    "DEFAULT_FAST_TRAINING_REPORT_FILE_NAME",
    "AcceleratorRuntimeConfig",
    "AccurateResearchRuntimeConfig",
    "AccurateRuntimeConfig",
    "AppConfig",
    "ArtifactProfileName",
    "AudioReadConfig",
    "DataLoaderConfig",
    "DatasetConfig",
    "FastRuntimeConfig",
    "FeatureFlags",
    "FeatureRuntimeBackendOverride",
    "FeatureRuntimePolicyConfig",
    "MediumRuntimeConfig",
    "MediumTrainingConfig",
    "MeshConfig",
    "ModelsConfig",
    "NeuralNetConfig",
    "OntologyConfig",
    "ProfileRuntimeConfig",
    "QualityGateConfig",
    "RuntimeFlags",
    "SchemaConfig",
    "TimelineConfig",
    "TorchRuntimeConfig",
    "TrainingConfig",
    "TranscriptionConfig",
    "WhisperModelConfig",
    "default_cache_root",
    "default_data_root",
    "default_profile_model_id",
    "profile_artifact_file_names",
]
