"""Public API of the PyTorch port: ``infer`` and ``train`` for the four emotion profiles,
``list_profiles``, ``load_profile`` and ``run_startup_preflight``.

Counterparts of ``ser_tpu.api.infer``, returning the same ``InferenceExecution``,
and ``ser_tpu.api.train``, which writes the same head artifact and training
report. Both run on the CUDA card unless the settings ask for the CPU
(``SER_TORCH_DEVICE=cpu`` or ``settings.torch_runtime.device == "cpu"``);
with no card and no such request they raise. The profiles:

- ``accurate``: the Whisper large-v3 encoder;
- ``medium``: the XLS-R 300M encoder (chunked masked encode, float32 retry
  after a non-finite bf16 encode, pooling on the host or, with
  ``SER_DEVICE_POOLING=1``, on the card);
- ``accurate-research``: the emotion2vec encoder (data2vec 2.0 audio, from a
  FunASR ``model.pt``), the medium profile's encode; behind the
  restricted-backend gate (``SER_ENABLE_RESTRICTED_BACKENDS=1`` and recorded
  consent or ``SER_ALLOWED_RESTRICTED_BACKENDS=emotion2vec``), refused with
  ``UnsupportedProfileError`` otherwise;
- ``fast``: handcrafted DSP features (MFCC, chroma, mel, contrast, tonnetz)
  of 3 s frames, computed on the card too, and the head of ``ser_model.pkl``.

``train(profile=...)`` runs readiness and quarantine over the corpus
(``SER_DATASET_FOLDER``; budgets ``SER_MAX_FAILED_FILES``,
``SER_MAX_FAILED_FILE_RATIO`` and its per-corpus and per-class forms,
``SER_MAX_FAILURES_PER_REASON``, ``SER_MIN_REMAINING_PER_CLASS_SPLIT``,
``SER_STRICT_QUARANTINE``), the selected backend's smoke under its deadline
(``SER_TRAINING_SMOKE_TIMEOUT_SECONDS``), the split (``SER_TEST_SIZE``,
``SER_DEV_SIZE``, ``SER_RANDOM_STATE``, ``SER_SPLIT_SALT``), the encode with
the embedding cache under ``SER_TMP_FOLDER``, window pooling and the noise
controls (``SER_MEDIUM_MIN_WINDOW_STD``, ``SER_MEDIUM_MAX_WINDOWS_PER_CLIP``),
the head's fit, the grouped metrics, and the artifact and report under
``SER_MODELS_FOLDER``, which ``infer`` then serves.

Each has the transcript lane (``include_transcript``, on by default as in
the JAX package: it needs a staged HF Whisper checkpoint under the Whisper
download root; with ``use_demucs``, on in the accurate profiles' catalog
entries or by ``WHISPER_DEMUCS``, the staged htdemucs or U-Net checkpoint of
``SER_SEPARATION_MODEL_PATH`` separates the vocals first, on the same device,
else REPET-SIM). ``save_transcript`` writes the timeline as CSV under
``SER_TRANSCRIPTS_FOLDER``, and ``subtitle_output_path`` / ``subtitle_format``
write it as ASS, SRT or VTT subtitles, the files the JAX package writes.

``load_profile(profile)`` checks that a profile can run under the settings
(its flag on, its license gate open, its modules importable) and raises
``UnsupportedProfileError`` otherwise, loading no weights;
``run_startup_preflight`` returns the structured startup diagnostics
(``DiagnosticReport``: the CUDA devices against the settings' device, each
profile's availability, the transcription assets and the fast artifact). The
dataset functions of ``ser_tpu.api`` are not ported yet.
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path
from typing import Protocol

import ser_tpu_torch._internal.api.diagnostics as _diagnostics_api
import ser_tpu_torch._internal.api.runtime as _runtime_api
from ser_tpu_torch.config import (
    AccurateResearchRuntimeConfig, AccurateRuntimeConfig, AppConfig, AudioReadConfig,
    DataLoaderConfig, DatasetConfig, FastRuntimeConfig, FeatureFlags,
    FeatureRuntimeBackendOverride, FeatureRuntimePolicyConfig, MediumRuntimeConfig,
    MediumTrainingConfig, ModelsConfig, NeuralNetConfig, QualityGateConfig,
    RuntimeFlags, SchemaConfig, TimelineConfig, TorchRuntimeConfig, TrainingConfig,
    TranscriptionConfig, WhisperModelConfig, reload_settings,
)
from ser_tpu_torch.diagnostics.domain import DiagnosticFinding, DiagnosticReport, DiagnosticSeverity
from ser_tpu_torch.domain import EmotionSegment, TimelineEntry, TranscriptWord
from ser_tpu_torch.profiles import ProfileName
from ser_tpu_torch.runtime.contracts import InferenceExecution, InferenceRequest, SubtitleFormat
from ser_tpu_torch.runtime.schema import FramePrediction, InferenceResult, SegmentPrediction


class RuntimePipeline(Protocol):
    """Minimal runtime pipeline contract exposed at the public API facade."""

    def run_training(self) -> None:
        """Runs training for the active profile."""
        ...

    def run_inference(self, request: InferenceRequest) -> InferenceExecution:
        """Runs inference for one audio request."""
        ...


type RuntimePipelineBuilder = Callable[[AppConfig], RuntimePipeline]


def _resolve_boundary_settings(settings: AppConfig | None) -> AppConfig:
    """Explicit settings or a fresh snapshot of the environment."""
    return settings if settings is not None else reload_settings()


def list_profiles() -> tuple[ProfileName, ...]:
    """Returns all registered runtime profile names."""
    return _runtime_api.list_profiles()


def load_profile(profile: ProfileName, *, settings: AppConfig | None = None) -> None:
    """Validates one runtime profile."""
    return _runtime_api.load_profile(profile, settings=_resolve_boundary_settings(settings))


def infer(
    file_path: str | Path,
    *,
    profile: ProfileName | None = "accurate",
    language: str | None = None,
    save_transcript: bool = False,
    include_transcript: bool = True,
    subtitle_output_path: str | None = None,
    subtitle_format: SubtitleFormat | None = None,
    settings: AppConfig | None = None,
    pipeline_builder: RuntimePipelineBuilder | None = None,
) -> InferenceExecution:
    """Runs inference for one audio file (settings default: a fresh env snapshot)."""
    return _runtime_api.infer(
        file_path,
        profile=profile,
        language=language,
        save_transcript=save_transcript,
        include_transcript=include_transcript,
        subtitle_output_path=subtitle_output_path,
        subtitle_format=subtitle_format,
        settings=_resolve_boundary_settings(settings),
        pipeline_builder=pipeline_builder,
    )


def train(
    *,
    profile: ProfileName | None = None,
    settings: AppConfig | None = None,
    pipeline_builder: RuntimePipelineBuilder | None = None,
) -> None:
    """Trains the profile's head end to end (settings default: a fresh env snapshot)."""
    _runtime_api.train(
        profile=profile, settings=_resolve_boundary_settings(settings), pipeline_builder=pipeline_builder
    )


def run_startup_preflight(
    *,
    include_transcription_checks: bool,
    settings: AppConfig | None = None,
) -> DiagnosticReport:
    """Runs structured startup diagnostics."""
    return _diagnostics_api.run_startup_preflight(
        settings=_resolve_boundary_settings(settings),
        include_transcription_checks=include_transcription_checks,
    )


__all__ = [
    "AccurateResearchRuntimeConfig", "AccurateRuntimeConfig", "AppConfig", "AudioReadConfig",
    "DataLoaderConfig", "DatasetConfig", "DiagnosticFinding", "DiagnosticReport",
    "DiagnosticSeverity", "EmotionSegment", "FastRuntimeConfig", "FeatureFlags",
    "FeatureRuntimeBackendOverride", "FeatureRuntimePolicyConfig", "FramePrediction",
    "InferenceExecution", "InferenceRequest", "InferenceResult", "MediumRuntimeConfig",
    "MediumTrainingConfig", "ModelsConfig", "NeuralNetConfig", "ProfileName",
    "QualityGateConfig", "RuntimeFlags", "RuntimePipeline", "RuntimePipelineBuilder",
    "SchemaConfig", "SegmentPrediction", "SubtitleFormat", "TimelineConfig",
    "TimelineEntry", "TorchRuntimeConfig", "TrainingConfig", "TranscriptWord",
    "TranscriptionConfig", "WhisperModelConfig", "infer", "list_profiles", "load_profile",
    "run_startup_preflight", "train",
]
