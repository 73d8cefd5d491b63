"""Per-profile inference boundary: load the head, then attempt, retry, raise.

Counterpart of ``ser_tpu/_internal/runtime/profile_boundary.py``:

- one single-flight lock per ``(profile, model_id or "default")``, held from
  the head's load until the last attempt returns (a timed-out in-process
  attempt is abandoned, not killed: its thread may still queue work on the
  card while the retry runs);
- each attempt runs its setup (backend, audio) untimed and its compute under
  the profile's ``timeout_seconds``: in a thread of this process, or with
  ``process_isolation`` in a worker started by ``spawn`` that rebuilds its
  settings from its own environment, its own CUDA context and its kernels
  from ``build/torch_kernels/`` (``_spawned_setup`` / ``_spawned_compute``,
  module-level so that the payload pickles);
- typed errors, ``FileNotFoundError`` and ``ValueError`` pass through; a
  device OOM becomes ``TransientInferenceError(hard_oom=True)``, with the
  failed attempt's frames cleared so that its tensors are freed before the
  retry; any other error becomes ``InferenceExecutionError``;
- the retry policy draws timeouts and transient errors from their own
  budgets, with the profile's backoff between attempts.

One deliberate difference: no CPU attempt follows a spent transient budget or
a hard OOM (the JAX package's ``on_exhausted_transient`` hook, which the
port's policy does not have). The port runs on
the CPU only when the settings ask for it, so the last
``TransientInferenceError`` raises to the caller.
"""

from __future__ import annotations

import traceback
from collections.abc import Callable
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models import artifacts
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.runtime import worker_lifecycle
from ser_tpu_torch._internal.runtime.errors import (
    InferenceError,
    InferenceExecutionError,
    ModelLoadError,
    ModelUnavailableError,
    TransientInferenceError,
)
from ser_tpu_torch._internal.runtime.oom import is_device_oom, parse_device_oom
from ser_tpu_torch._internal.runtime.policy import RetryPolicy, run_with_retry_policy
from ser_tpu_torch._internal.runtime.postprocessing import build_segment_postprocessing_config
from ser_tpu_torch._internal.runtime.profile_execution import run_windowed_inference_once
from ser_tpu_torch._internal.runtime.single_flight import GLOBAL_SINGLE_FLIGHT
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
            "Train this profile first (api.train).",
            profile=spec.profile,
        ) from err
    except artifacts.ArtifactError as err:
        raise ModelLoadError(str(err), profile=spec.profile) from err


def _read_audio(file_path: str, settings: AppConfig) -> tuple[np.ndarray, int]:
    audio, sample_rate = read_audio_file(file_path, audio_read_config=settings.audio_read)
    return np.asarray(audio, dtype=np.float32), sample_rate


def _compute(
    context: dict[str, Any], *, loaded: artifacts.LoadedModel, profile: ProfileName, settings: AppConfig
) -> InferenceResult:
    runtime = settings.profile_runtime(profile)
    return run_windowed_inference_once(
        audio=context["audio"],
        sample_rate=context["sample_rate"],
        backend=context["backend"],
        model=loaded.model,
        pool_window_size_seconds=runtime.pool_window_size_seconds,
        pool_window_stride_seconds=runtime.pool_window_stride_seconds,
        postprocessing_config=build_segment_postprocessing_config(runtime),
        output_schema_version=settings.schema.output_schema_version,
        expected_feature_size=loaded.expected_feature_size,
    )


def _spawned_setup(profile: ProfileName, file_path: str) -> dict[str, Any]:
    """A spawned worker's setup: settings from the worker's environment, then head, backend and audio.

    Overrides the parent applied to its settings object do not cross the
    process boundary, as in the JAX package.
    """
    from ser_tpu_torch._internal.config.bootstrap import reload_settings
    from ser_tpu_torch._internal.runtime.backend_hooks import build_profile_spec

    settings = reload_settings()
    spec = build_profile_spec(profile, settings)
    loaded = _load_model(spec, settings)
    backend = spec.backend_factory(settings)
    audio, sample_rate = _read_audio(file_path, settings)
    return {
        "backend": backend,
        "audio": audio,
        "sample_rate": sample_rate,
        "loaded": loaded,
        "profile": profile,
        "settings": settings,
    }


def _spawned_compute(context: dict[str, Any]) -> InferenceResult:
    return _compute(context, loaded=context["loaded"], profile=context["profile"], settings=context["settings"])


def _device_oom_error(err: BaseException, profile: ProfileName) -> TransientInferenceError:
    """The retryable form of a device OOM; the failed attempt's frames are cleared first.

    Their locals hold the attempt's tensors, and the traceback keeps them alive
    (through the chained cause) past the attempt: a retry would then meet the
    first attempt's memory still allocated.
    """
    traceback.clear_frames(err.__traceback__)
    info = parse_device_oom(err)
    detail = f" (requested {info.requested_bytes} B)" if info.requested_bytes else ""
    return TransientInferenceError(
        f"Device OOM during inference{detail}; retry eligible.", profile=profile, hard_oom=True
    )


def run_profile_inference(
    request: InferenceRequest, *, spec: ProfileBoundarySpec, settings: AppConfig
) -> InferenceResult:
    """Runs one windowed-profile inference under the retry policy and the single flight."""
    runtime = settings.profile_runtime(spec.profile)
    with GLOBAL_SINGLE_FLIGHT.acquire(spec.profile, spec.model_id or "default"):
        loaded = _load_model(spec, settings)

        def setup() -> dict[str, Any]:
            backend = spec.backend_factory(settings)
            audio, sample_rate = _read_audio(request.file_path, settings)
            return {"backend": backend, "audio": audio, "sample_rate": sample_rate}

        def attempt() -> InferenceResult:
            try:
                if runtime.process_isolation:
                    return worker_lifecycle.run_attempt_in_spawned_process(
                        setup=partial(_spawned_setup, spec.profile, request.file_path),
                        compute=_spawned_compute,
                        timeout_seconds=runtime.timeout_seconds,
                        profile=spec.profile,
                    )
                return worker_lifecycle.run_attempt_in_process(
                    setup=setup,
                    compute=partial(_compute, loaded=loaded, profile=spec.profile, settings=settings),
                    timeout_seconds=runtime.timeout_seconds,
                    profile=spec.profile,
                )
            except (InferenceError, FileNotFoundError, ValueError):
                raise
            except Exception as err:
                if is_device_oom(err):
                    raise _device_oom_error(err, spec.profile) from err
                raise InferenceExecutionError(f"{type(err).__name__}: {err}", profile=spec.profile) from err

        policy = RetryPolicy(
            max_timeout_retries=runtime.max_timeout_retries,
            max_transient_retries=runtime.max_transient_retries,
            retry_backoff_seconds=runtime.retry_backoff_seconds,
        )
        return run_with_retry_policy(attempt, policy=policy)


__all__ = ["BackendFactory", "ProfileBoundarySpec", "run_profile_inference"]
