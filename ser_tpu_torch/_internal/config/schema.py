"""Frozen settings snapshot of the PyTorch port (the fields its path reads).

Counterpart of ``ser_tpu/_internal/config/schema.py``. Field names, defaults
and the platform cache/data directories are the JAX package's, so one
environment configures both packages alike. Only the sections the accurate
profile's inference path reads are here; the full settings builder is later
work (``ROADMAP.md``).
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
class ModelsConfig:
    """Where trained artifacts and model caches live."""

    folder: Path = field(default_factory=lambda: default_data_root() / "models")
    model_cache_dir: Path = field(default_factory=lambda: default_cache_root() / "model-cache")
    accurate_model_id: str = field(default_factory=lambda: default_profile_model_id("accurate"))

    @property
    def huggingface_cache_root(self) -> Path:
        return self.model_cache_dir / "huggingface"


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
    accurate_runtime: ProfileRuntimeDefaults = field(
        default_factory=lambda: require_ported("accurate").runtime_defaults
    )
    schema: SchemaConfig = field(default_factory=SchemaConfig)
    torch_runtime: TorchRuntimeConfig = field(default_factory=TorchRuntimeConfig)
    default_language: str = "en"

    def profile_runtime(self, profile: ProfileName) -> ProfileRuntimeDefaults:
        require_ported(profile)
        return self.accurate_runtime


__all__ = [
    "AppConfig",
    "AudioReadConfig",
    "ModelsConfig",
    "RuntimeFlags",
    "SchemaConfig",
    "TorchRuntimeConfig",
    "default_cache_root",
    "default_data_root",
    "default_profile_model_id",
]
