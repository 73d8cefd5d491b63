"""Training readiness, first part: the failure taxonomy.

Counterpart of ``ser_tpu/_internal/models/training_readiness.py:45-250``:
the finding and failure enums (their values are a persistence contract:
ledgers and reports carry them verbatim), ``CacheEntryCorruptError`` and the
other containment errors, ``FailureClassification`` and ``classify_failure``,
whose default is to abort: only a known error type at a known scope may be
contained. The embedding cache reads it for a corrupt entry. The rest of the
module (readiness findings, quarantine budgets, prepared plans, the backend
smoke) comes with the next slice of the training pipeline (``ROADMAP.md``).
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass
from enum import Enum
from pathlib import Path


class FindingScope(str, Enum):
    CONFIG = "config"
    MEDIA = "media"
    SPLIT = "split"
    RESOURCE = "resource"


class FindingSeverity(str, Enum):
    INFO = "info"
    WARNING = "warning"
    BLOCKING = "blocking"


class FailureScope(str, Enum):
    """Scope at which a training failure is known to apply (reference ``:107-116``)."""

    RUN = "run"
    CORPUS = "corpus"
    SAMPLE = "sample"
    WINDOW = "window"
    CACHE = "cache"
    OPTIONAL_ARTIFACT = "optional_artifact"


class FailureDisposition(str, Enum):
    """Permitted action after one classified failure (reference ``:118-127``)."""

    ABORT = "abort"
    REPAIR_THEN_RETRY = "repair_then_retry"
    BOUNDED_RETRY = "bounded_retry"
    RECOMPUTE = "recompute"
    QUARANTINE = "quarantine"
    CONTINUE = "continue"


class FailureReasonCode(str, Enum):
    """Stable reason codes emitted by readiness and containment (reference ``:138-170``).

    These strings are a persistence contract — quarantine ledgers, readiness
    reports, and prepared-plan rejections carry them verbatim.
    """

    INVALID_CONFIGURATION = "invalid_configuration"
    DATASET_NOT_FOUND = "dataset_not_found"
    REGISTRY_UNHEALTHY = "registry_unhealthy"
    MANIFEST_INVALID = "manifest_invalid"
    MEDIA_MISSING = "media_missing"
    MEDIA_NOT_REGULAR = "media_not_regular"
    MEDIA_EMPTY = "media_empty"
    MEDIA_DECODE_FAILED = "media_decode_failed"
    GIT_LFS_POINTER = "git_lfs_pointer"
    DUPLICATE_SAMPLE_ID = "duplicate_sample_id"
    DUPLICATE_CONTENT = "duplicate_content"
    PATH_ALIAS = "path_alias"
    INSUFFICIENT_CLASS_SUPPORT = "insufficient_class_support"
    SPLIT_LEAKAGE = "split_leakage"
    OUTPUT_UNWRITABLE = "output_unwritable"
    DISK_SPACE_LOW = "disk_space_low"
    RESOURCE_LIMIT = "resource_limit"
    BACKEND_UNAVAILABLE = "backend_unavailable"
    BACKEND_SMOKE_TIMEOUT = "backend_smoke_timeout"
    BACKEND_OUTPUT_INVALID = "backend_output_invalid"
    SAMPLE_AUDIO_CORRUPT = "sample_audio_corrupt"
    SAMPLE_AUDIO_MISSING = "sample_audio_missing"
    WINDOW_LOW_VARIANCE = "window_low_variance"
    CACHE_CORRUPT = "cache_corrupt"
    OPTIONAL_ARTIFACT_FAILED = "optional_artifact_failed"
    QUARANTINE_BUDGET_EXCEEDED = "quarantine_budget_exceeded"
    PREPARED_PLAN_INVALID = "prepared_plan_invalid"
    REPAIR_FAILED = "repair_failed"


class WindowContainmentError(ValueError):
    """A pooling window failed its variance/containment contract."""


class CacheEntryCorruptError(ValueError):
    """A persisted embedding-cache entry failed to load."""


class OptionalArtifactError(OSError):
    """A best-effort artifact (report, trace) could not be written."""


@dataclass(frozen=True)
class FailureClassification:
    """One classified failure: where it applies and what may happen next."""

    scope: FailureScope
    reason_code: FailureReasonCode
    disposition: FailureDisposition
    severity: FindingSeverity
    diagnostic: str


#: Errno values that signal transient local IO pressure worth one bounded
#: retry before quarantining the sample (reference ``:54``).
_TRANSIENT_LOCAL_IO_ERRNOS = frozenset({11, 16, 4, 110})  # EAGAIN EBUSY EINTR ETIMEDOUT


def classify_failure(
    error: Exception,
    *,
    scope: FailureScope,
    sample_path: str | Path | None = None,
    allowed_roots: Sequence[Path] = (),
) -> FailureClassification:
    """Classifies only known exception types; unknown failures remain aborting.

    Reference decision ladder (``training_readiness.py:704-791``): the default
    is ABORT — containment (quarantine / retry / recompute / continue) is a
    privilege PROVEN by the exception type and scope, never assumed, so a
    novel defect stops training instead of silently shrinking the dataset.
    """
    from ser_tpu_torch._internal.utils.audio_io import AudioDecodeError, AudioIntegrityError

    diagnostic = (str(error).strip() or type(error).__name__)[:500]
    if isinstance(error, AudioIntegrityError) and "Git LFS" in diagnostic:
        return FailureClassification(
            FailureScope.CORPUS,
            FailureReasonCode.GIT_LFS_POINTER,
            FailureDisposition.ABORT,
            FindingSeverity.BLOCKING,
            diagnostic,
        )
    if scope is FailureScope.WINDOW and isinstance(error, WindowContainmentError):
        return FailureClassification(
            scope,
            FailureReasonCode.WINDOW_LOW_VARIANCE,
            FailureDisposition.CONTINUE,
            FindingSeverity.WARNING,
            diagnostic,
        )
    if scope is FailureScope.CACHE and isinstance(error, CacheEntryCorruptError):
        return FailureClassification(
            scope,
            FailureReasonCode.CACHE_CORRUPT,
            FailureDisposition.RECOMPUTE,
            FindingSeverity.WARNING,
            diagnostic,
        )
    if scope is FailureScope.OPTIONAL_ARTIFACT and isinstance(error, OptionalArtifactError):
        return FailureClassification(
            scope,
            FailureReasonCode.OPTIONAL_ARTIFACT_FAILED,
            FailureDisposition.CONTINUE,
            FindingSeverity.WARNING,
            diagnostic,
        )
    if scope is FailureScope.SAMPLE and (
        isinstance(error, (TimeoutError, InterruptedError))
        or (
            isinstance(error, OSError)
            and not isinstance(error, (AudioDecodeError, AudioIntegrityError))
            and error.errno in _TRANSIENT_LOCAL_IO_ERRNOS
        )
    ):
        return FailureClassification(
            scope,
            FailureReasonCode.MEDIA_DECODE_FAILED,
            FailureDisposition.BOUNDED_RETRY,
            FindingSeverity.WARNING,
            diagnostic,
        )
    if (
        scope is FailureScope.SAMPLE
        and isinstance(error, FileNotFoundError)
        and sample_path is not None
    ):
        # A vanished sample only quarantines when the missing path is PROVEN
        # to be this sample inside an allowed root — any other missing file
        # (a model asset, a config) is a run defect, not a sample defect.
        failed = error.filename
        if isinstance(failed, str):
            failed_path = Path(failed).expanduser().resolve(strict=False)
            resolved_sample = Path(sample_path).expanduser().resolve(strict=False)
            if failed_path == resolved_sample and any(
                resolved_sample.is_relative_to(root.expanduser().resolve(strict=False))
                for root in allowed_roots
            ):
                return FailureClassification(
                    scope,
                    FailureReasonCode.SAMPLE_AUDIO_MISSING,
                    FailureDisposition.QUARANTINE,
                    FindingSeverity.WARNING,
                    diagnostic,
                )
    if scope is FailureScope.SAMPLE and isinstance(error, AudioDecodeError):
        return FailureClassification(
            scope,
            FailureReasonCode.SAMPLE_AUDIO_CORRUPT,
            FailureDisposition.QUARANTINE,
            FindingSeverity.WARNING,
            diagnostic,
        )
    return FailureClassification(
        scope,
        FailureReasonCode.BACKEND_OUTPUT_INVALID,
        FailureDisposition.ABORT,
        FindingSeverity.BLOCKING,
        diagnostic,
    )


__all__ = [
    "CacheEntryCorruptError",
    "FailureClassification",
    "FailureDisposition",
    "FailureReasonCode",
    "FailureScope",
    "FindingScope",
    "FindingSeverity",
    "OptionalArtifactError",
    "WindowContainmentError",
    "classify_failure",
]
