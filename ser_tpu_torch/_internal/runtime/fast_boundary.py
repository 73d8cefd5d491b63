"""Fast-profile inference boundary: load the head, then attempt under the retry policy.

Counterpart of ``ser_tpu/_internal/runtime/fast_boundary.py``: the single
flight on ``("fast", "default")`` around the head's load and the attempts;
each attempt runs in this process under the fast profile's
``timeout_seconds`` (the catalog's budgets are all zero: no timeout, one
attempt); typed errors, ``FileNotFoundError`` and ``ValueError`` pass
through and any other error becomes ``InferenceExecutionError``, which no
budget retries.
"""

from __future__ import annotations

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models import artifacts, emotion_model
from ser_tpu_torch._internal.runtime.errors import (
    InferenceError,
    InferenceExecutionError,
    ModelLoadError,
    ModelUnavailableError,
)
from ser_tpu_torch._internal.runtime.policy import RetryPolicy, run_with_retry_policy
from ser_tpu_torch._internal.runtime.single_flight import GLOBAL_SINGLE_FLIGHT
from ser_tpu_torch._internal.runtime.worker_lifecycle import run_attempt_in_process
from ser_tpu_torch.runtime.contracts import InferenceRequest
from ser_tpu_torch.runtime.schema import InferenceResult


def run_fast_inference(request: InferenceRequest, *, settings: AppConfig) -> InferenceResult:
    """Runs one fast-profile inference: the ``ser_tpu_mlp`` head over handcrafted frame features."""
    runtime = settings.fast_runtime
    with GLOBAL_SINGLE_FLIGHT.acquire("fast", "default"):
        try:
            loaded = emotion_model.load_model(settings=settings, profile="fast")
        except FileNotFoundError as err:
            raise ModelUnavailableError(
                f"No trained fast-profile artifact at {settings.models.model_file}. Train it first.",
                profile="fast",
            ) from err
        except artifacts.ArtifactError as err:
            raise ModelLoadError(str(err), profile="fast") from err

        def attempt() -> InferenceResult:
            try:
                return run_attempt_in_process(
                    setup=lambda: None,
                    compute=lambda _: emotion_model.predict_emotions_detailed(
                        request.file_path, settings=settings, loaded=loaded
                    ),
                    timeout_seconds=runtime.timeout_seconds,
                    profile="fast",
                )
            except (InferenceError, FileNotFoundError, ValueError):
                raise
            except Exception as err:
                raise InferenceExecutionError(f"{type(err).__name__}: {err}", profile="fast") from err

        return run_with_retry_policy(
            attempt,
            policy=RetryPolicy(
                max_timeout_retries=runtime.max_timeout_retries,
                max_transient_retries=runtime.max_transient_retries,
                retry_backoff_seconds=runtime.retry_backoff_seconds,
            ),
        )


__all__ = ["run_fast_inference"]
