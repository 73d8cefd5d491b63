"""Frozen settings snapshot of the PyTorch port (the fields its path reads).

Counterpart of ``ser_tpu/_internal/config/schema.py``. Field names, defaults
and the platform cache/data directories are the JAX package's, so one
environment configures both packages alike. Only the sections the medium and
accurate profiles' inference paths and their transcript lane read are here;
the full settings builder is later work (``ROADMAP.md``).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

from ser_tpu_torch.profiles import ProfileName, ProfileRuntimeDefaults, require_ported
from ser_tpu_torch.runtime.schema import OUTPUT_SCHEMA_VERSION

APP_NAME = "ser"


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


def default_profile_model_id(profile: ProfileName) -> str:
    """The catalog's default model id for one ported profile."""
    return require_ported(profile).default_model_id


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
    whisper_model: WhisperModelConfig = field(default_factory=WhisperModelConfig)

    @property
    def huggingface_cache_root(self) -> Path:
        return self.model_cache_dir / "huggingface"

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
    hbm_admission_control_enabled: bool = True
    hbm_admission_min_headroom_mb: float = 256.0
    hbm_admission_safety_margin_mb: float = 256.0
    calibration_overrides_enabled: bool = True
    calibration_min_confidence: str = "high"
    calibration_report_max_age_hours: float = 168.0
    calibration_report_path: Path | None = None
    separation_model_path: Path | None = None
    process_isolation: bool = False


@dataclass(frozen=True)
class RuntimeFlags:
    """Profile enable flags."""

    profile_pipeline: bool = False
    medium_profile: bool = False
    accurate_profile: bool = False
    accurate_research_profile: bool = False


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

    audio_read: AudioReadConfig = field(default_factory=AudioReadConfig)
    models: ModelsConfig = field(default_factory=ModelsConfig)
    runtime_flags: RuntimeFlags = field(default_factory=RuntimeFlags)
    medium_runtime: ProfileRuntimeDefaults = field(default_factory=lambda: require_ported("medium").runtime_defaults)
    accurate_runtime: ProfileRuntimeDefaults = field(
        default_factory=lambda: require_ported("accurate").runtime_defaults
    )
    schema: SchemaConfig = field(default_factory=SchemaConfig)
    torch_runtime: TorchRuntimeConfig = field(default_factory=TorchRuntimeConfig)
    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    tmp_folder: Path = field(default_factory=lambda: default_cache_root() / "tmp")
    default_language: str = "en"

    def profile_runtime(self, profile: ProfileName) -> ProfileRuntimeDefaults:
        require_ported(profile)
        return {"medium": self.medium_runtime, "accurate": self.accurate_runtime}[profile]

    def profile_model_id(self, profile: ProfileName) -> str:
        """The model id the profile's backend loads (the settings override the catalog's)."""
        require_ported(profile)
        return {"medium": self.models.medium_model_id, "accurate": self.models.accurate_model_id}[profile]


__all__ = [
    "AppConfig",
    "AudioReadConfig",
    "ModelsConfig",
    "RuntimeFlags",
    "SchemaConfig",
    "TorchRuntimeConfig",
    "TranscriptionConfig",
    "WhisperModelConfig",
    "default_cache_root",
    "default_data_root",
    "default_profile_model_id",
]
