"""Per-profile inference boundary: load the head, build the backend, run one pass.

Counterpart of ``ser_tpu/_internal/runtime/profile_boundary.py`` without its
retry ladder, soft timeout, spawned worker, single-flight lock and CPU
fallback attempt: an error on the card raises to the caller. Those wait for a
later slice (``ROADMAP.md``).
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime.errors import ModelLoadError, ModelUnavailableError
from ser_tpu_torch._internal.runtime.postprocessing import build_segment_postprocessing_config
from ser_tpu_torch._internal.runtime.profile_execution import run_windowed_inference_once
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch.profiles import ProfileName
from ser_tpu_torch.runtime.contracts import InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult

type BackendFactory = Callable[[AppConfig], Any]


@dataclass(frozen=True)
class ProfileBoundarySpec:
    """Everything the boundary needs to run one profile."""

    profile: ProfileName
    backend_id: str
    model_id: str | None
    backend_factory: BackendFactory
    artifact_file_name: str


def _load_model(spec: ProfileBoundarySpec, settings: AppConfig) -> artifacts.LoadedModel:
    path = settings.models.folder / spec.artifact_file_name
    try:
        return artifacts.load_model_artifact(
            path,
            expected_backend_id=spec.backend_id,
            expected_profile=spec.profile,
            expected_model_id=spec.model_id,
            device=resolve_device(settings.torch_runtime.device),
        )
    except FileNotFoundError as err:
        raise ModelUnavailableError(
            f"No trained artifact for profile {spec.profile!r} at {path}. "
            "Train this profile with ser_tpu first.",
            profile=spec.profile,
        ) from err
    except artifacts.ArtifactError as err:
        raise ModelLoadError(str(err), profile=spec.profile) from err


def run_profile_inference(
    request: InferenceRequest, *, spec: ProfileBoundarySpec, settings: AppConfig
) -> InferenceResult:
    """Runs one windowed-profile inference on the resolved device."""
    runtime = settings.profile_runtime(spec.profile)
    backend = spec.backend_factory(settings)
    loaded = _load_model(spec, settings)
    audio, sample_rate = read_audio_file(request.file_path, audio_read_config=settings.audio_read)
    return run_windowed_inference_once(
        audio=np.asarray(audio, dtype=np.float32),
        sample_rate=sample_rate,
        backend=backend,
        model=loaded.model,
        pool_window_size_seconds=runtime.pool_window_size_seconds,
        pool_window_stride_seconds=runtime.pool_window_stride_seconds,
        postprocessing_config=build_segment_postprocessing_config(runtime),
        output_schema_version=settings.schema.output_schema_version,
        expected_feature_size=loaded.expected_feature_size,
    )


__all__ = ["BackendFactory", "ProfileBoundarySpec", "run_profile_inference"]
