"""Command runners with exception → exit-code classification.

Counterpart of ``ser_tpu/_internal/runtime/commands.py``: exit code 2 for
user-actionable errors (missing files, an unsupported profile, a shut license
gate, a missing dependency or model, a per-profile inference timeout), 3 for
transcription failures, 1 for every other failure, 0 on success. Training
classifies only its readiness failures as 2; the general workflow (data,
benchmark, calibration) adds ``ValueError``.
"""


from __future__ import annotations

from collections.abc import Callable
from typing import TypeVar

from ser_tpu_torch._internal.runtime.errors import (
    InferenceTimeoutError,
    ModelLoadError,
    ModelUnavailableError,
    RuntimeDependencyError,
)
from ser_tpu_torch._internal.runtime.registry import UnsupportedProfileError
from ser_tpu_torch._internal.runtime.restricted_backends import RestrictedBackendError
from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

EXIT_OK = 0
EXIT_RUNTIME = 1
EXIT_VALIDATION = 2
EXIT_TRANSCRIPTION = 3

T = TypeVar("T")

# License/policy gates, dependency/model load/unavailable errors, per-profile
# inference TIMEOUTS, and missing files are all user-actionable → exit 2.
# Plain ValueError is NOT in that tuple — an unexpected ValueError escaping
# inference is a runtime failure (exit 1).
_INFERENCE_VALIDATION_ERRORS = (
    FileNotFoundError,
    UnsupportedProfileError,
    RestrictedBackendError,
    RuntimeDependencyError,
    ModelLoadError,
    ModelUnavailableError,  # user-actionable precondition: train first
    InferenceTimeoutError,  # user-actionable: raise the profile timeout budget
)

# Dataset/calibration commands treat ValueError and consent errors as
# user-actionable too.
_GENERAL_VALIDATION_ERRORS = (
    ValueError,
    *_INFERENCE_VALIDATION_ERRORS,
)


def classify_exit_code(error: BaseException, *, workflow: str = "general") -> int:
    """Maps one failure to its stable CLI exit code.

    ``workflow`` selects the classifier: ``"inference"``, ``"training"``, or
    ``"general"`` for data/benchmark/calibration commands.
    """
    from ser_tpu_torch._internal.models.training_orchestration import (
        QuarantineBudgetExceeded,
        TrainingNotReadyError,
    )
    from ser_tpu_torch._internal.models.training_readiness import PreparedPlanError
    from ser_tpu_torch._internal.transcript.extractor import TranscriptionError

    if workflow == "training":
        # Only the readiness-contract failures are user-actionable; every
        # other training exception (ValueError included) is exit 1.
        if isinstance(
            error, (TrainingNotReadyError, QuarantineBudgetExceeded, PreparedPlanError)
        ):
            return EXIT_VALIDATION
        return EXIT_RUNTIME

    if isinstance(error, TranscriptionError):
        return EXIT_TRANSCRIPTION
    validation = (
        _INFERENCE_VALIDATION_ERRORS
        if workflow == "inference"
        else _GENERAL_VALIDATION_ERRORS
    )
    if isinstance(error, validation):
        return EXIT_VALIDATION
    return EXIT_RUNTIME


def run_command(
    operation: Callable[[], T], *, label: str, workflow: str = "general"
) -> tuple[T | None, int]:
    """Runs one workflow; returns (result, exit_code) with errors logged."""
    try:
        return operation(), EXIT_OK
    except KeyboardInterrupt:
        logger.warning("%s interrupted.", label)
        return None, EXIT_RUNTIME
    except BaseException as err:  # noqa: BLE001 - the CLI boundary reports everything
        code = classify_exit_code(err, workflow=workflow)
        logger.error("%s failed (%s): %s", label, type(err).__name__, err)
        return None, code


__all__ = [
    "EXIT_OK",
    "EXIT_RUNTIME",
    "EXIT_TRANSCRIPTION",
    "EXIT_VALIDATION",
    "classify_exit_code",
    "run_command",
]
