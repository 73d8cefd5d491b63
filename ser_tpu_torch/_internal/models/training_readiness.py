"""Pre-training readiness: findings, quarantine budgets, the backend smoke, prepared plans.

Counterpart of ``ser_tpu/_internal/models/training_readiness.py``:

- the failure taxonomy (scopes, severities, reason codes, whose values are a
  persistence contract: ledgers and reports carry them verbatim) and
  ``classify_failure``, whose default is to abort;
- the config, media, quarantine-budget, split, registry, restricted-backend,
  resource and recipe findings of ``run_training_readiness``, with the full
  quarantine taxonomy (absolute, global, per-corpus and per-class ratios,
  per-reason counts, the per-class floor, strict mode);
- the selected backend's smoke over a stratified sample under a SIGALRM
  wall-clock deadline (``SER_TRAINING_SMOKE_TIMEOUT_SECONDS``, in (0, 600];
  by default 420 s on the card, where the first encode also builds the
  kernels, and 120 s on the CPU). Like the JAX package's, the alarm fires
  between Python bytecodes only: it cannot interrupt a kernel launch or a
  blocking synchronize;
- prepared plans signed by the settings, quarantine-ledger, split, salt and
  recipe digests and by the backend fingerprint (backend, model id, device,
  dtype), the quarantine ledgers, and the readiness report. On the CPU the
  digests, plans and ledgers are the JAX package's, so a plan or ledger
  written by either package loads in the other; on the card the fingerprint
  names ``cuda``, so a plan prepared there does not resume on another device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import Counter
from collections.abc import Sequence
from contextlib import contextmanager
from dataclasses import dataclass
from enum import Enum
from hashlib import sha256
from pathlib import Path

import numpy as np
import torch

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.data import loader
from ser_tpu_torch._internal.data.manifest import normalized_pcm_sha256
from ser_tpu_torch._internal.utils.audio_io import read_audio_file
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.profiles import ProfileName

logger = get_logger(__name__)

PLAN_SCHEMA_VERSION = 1


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


@dataclass(frozen=True)
class ReadinessFinding:
    """One readiness check outcome."""

    scope: FindingScope
    severity: FindingSeverity
    reason: str
    message: str
    sample_id: str | None = None


@dataclass(frozen=True)
class ReadinessReport:
    """All findings + the quarantine decision for one readiness run."""

    profile: ProfileName
    findings: tuple[ReadinessFinding, ...]
    quarantined_files: tuple[str, ...]
    usable_files: tuple[str, ...]
    #: Corpus/label/speaker attribution per usable file (manifest-aware) and
    #: the normalized-PCM digest captured during the media probe — prepared
    #: plans reuse both instead of re-deriving labels from RAVDESS filename
    #: codes (wrong for manifest corpora) or re-decoding the corpus.
    usable_records: tuple["FileRecord", ...] = ()
    usable_digests: tuple[str, ...] = ()

    @property
    def blocking(self) -> bool:
        return any(f.severity is FindingSeverity.BLOCKING for f in self.findings)


@dataclass(frozen=True)
class QuarantinePolicy:
    """Bias-aware quarantine limits (reference ``:207-292`` semantics).

    Ratios bound how much of any corpus or class may silently disappear;
    strict mode refuses any quarantine at all.
    """

    max_absolute: int
    max_global_ratio: float
    max_corpus_ratio: float
    max_class_ratio: float
    max_per_reason: int
    min_remaining_per_class_split: int
    strict: bool = False

    def __post_init__(self) -> None:
        import math

        for name in ("max_absolute", "max_per_reason", "min_remaining_per_class_split"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be non-negative.")
        for name in ("max_global_ratio", "max_corpus_ratio", "max_class_ratio"):
            ratio = getattr(self, name)
            if not math.isfinite(ratio) or not 0.0 <= ratio <= 1.0:
                raise ValueError(f"{name} must be finite and within [0, 1].")

    @classmethod
    def from_settings(cls, settings: AppConfig) -> "QuarantinePolicy":
        config = settings.data_loader
        return cls(
            max_absolute=config.max_failed_files,
            max_global_ratio=config.max_failed_file_ratio,
            max_corpus_ratio=config.max_failed_file_ratio_per_corpus,
            max_class_ratio=config.max_failed_file_ratio_per_class,
            max_per_reason=config.max_failures_per_reason,
            min_remaining_per_class_split=config.min_remaining_per_class_split,
            strict=config.strict_quarantine,
        )


@dataclass(frozen=True)
class FileRecord:
    """One dataset file with its corpus and (optional) label + speaker."""

    path: str
    corpus: str
    label: str | None
    speaker: str | None = None
    language: str | None = None


def _file_records(files: list[str], settings: AppConfig) -> list[FileRecord]:
    """Attributes corpus + label + speaker per file.

    Manifest-configured datasets carry explicit corpus/label/speaker; the
    RAVDESS glob path derives labels from the filename adapter with corpus
    ``ravdess``. Manifest rows match discovered files on RESOLVED paths —
    relative manifest paths vs absolute glob paths must not silently drop
    the attribution (that would fold every corpus into a fictitious
    'ravdess' and mis-scope the per-corpus quarantine budgets).
    """
    by_path: dict[str, tuple[str, str, str | None, str | None]] = {}
    if settings.dataset.manifest_paths:
        try:
            for utterance in loader.load_utterances(settings=settings) or []:
                key = str(Path(utterance.audio_path).resolve())
                by_path[key] = (
                    utterance.corpus,
                    utterance.label,
                    utterance.speaker_id,
                    utterance.language,
                )
        except Exception as err:  # noqa: BLE001 - manifest defects surface later
            logger.warning("Manifest attribution unavailable: %s", err)
    emotion_map = dict(settings.emotions)
    records = []
    for file in files:
        resolved = str(Path(file).resolve())
        if resolved in by_path:
            corpus, label, speaker, language = by_path[resolved]
        else:
            corpus = "ravdess"
            label = emotion_map.get(
                loader.extract_ravdess_emotion_code(Path(file).name) or ""
            )
            speaker = loader.extract_ravdess_speaker_id_from_path(file)
            language = "en"  # RAVDESS adapter default (reference adapters/ravdess.py:102)
        records.append(
            FileRecord(
                path=file, corpus=corpus, label=label, speaker=speaker, language=language
            )
        )
    return records


#: Device selectors the port's runtime policy resolves (``repr/runtime_policy.py``):
#: the CUDA card under its names, or the CPU by name.
_ALLOWED_DEVICE_SELECTORS = frozenset({"auto", "cpu", "cuda", "gpu", "accelerator"})
_ALLOWED_DTYPE_SELECTORS = frozenset({"auto", "float16", "float32", "bfloat16"})


def _blocking_config(reason: str, message: str) -> ReadinessFinding:
    return ReadinessFinding(FindingScope.CONFIG, FindingSeverity.BLOCKING, reason, message)


def _config_findings(settings: AppConfig) -> list[ReadinessFinding]:
    """Validates every training-relevant knob before any media is touched.

    Reference breadth: ``ser/_internal/models/training_readiness.py:975-1195``
    — unit-interval splits, data-loader failure budgets, classifier
    hyper-parameters, all four per-profile runtime envelopes (timeouts,
    retry budgets, pooling window geometry, postprocessing hysteresis),
    device/dtype selectors, and quarantine-policy construction.
    """
    import math

    findings: list[ReadinessFinding] = []
    folder = settings.dataset.folder
    if not folder.exists():
        findings.append(
            _blocking_config(
                "dataset_folder_missing", f"Dataset folder does not exist: {folder}"
            )
        )

    numeric_checks: tuple[tuple[str, float, object], ...] = (
        ("training.test_size", settings.training.test_size, lambda v: 0.0 < v < 1.0),
        ("training.dev_size", settings.training.dev_size, lambda v: 0.0 < v < 1.0),
        (
            "data_loader.max_failed_file_ratio",
            settings.data_loader.max_failed_file_ratio,
            lambda v: 0.0 <= v <= 1.0,
        ),
        (
            "data_loader.max_failed_file_ratio_per_corpus",
            settings.data_loader.max_failed_file_ratio_per_corpus,
            lambda v: 0.0 <= v <= 1.0,
        ),
        (
            "data_loader.max_failed_file_ratio_per_class",
            settings.data_loader.max_failed_file_ratio_per_class,
            lambda v: 0.0 <= v <= 1.0,
        ),
        (
            "audio_read.retry_delay_seconds",
            settings.audio_read.retry_delay_seconds,
            lambda v: v >= 0.0,
        ),
        ("nn.alpha", settings.nn.alpha, lambda v: v >= 0.0),
        ("nn.epsilon", settings.nn.epsilon, lambda v: v > 0.0),
        (
            "medium_training.min_window_std",
            settings.medium_training.min_window_std,
            lambda v: v >= 0.0,
        ),
    )
    for name, value, predicate in numeric_checks:
        if not math.isfinite(value) or not predicate(value):
            findings.append(
                _blocking_config(
                    "invalid_configuration", f"Invalid training setting {name}={value!r}."
                )
            )
    if settings.training.test_size + settings.training.dev_size >= 1.0:
        findings.append(
            _blocking_config(
                "invalid_configuration",
                "training.test_size + training.dev_size must be below 1.0.",
            )
        )

    for profile_name in ("fast", "medium", "accurate", "accurate-research"):
        runtime = settings.profile_runtime(profile_name)
        runtime_values = (
            ("timeout_seconds", runtime.timeout_seconds, lambda v: v >= 0.0),
            ("retry_backoff_seconds", runtime.retry_backoff_seconds, lambda v: v >= 0.0),
            ("pool_window_size_seconds", runtime.pool_window_size_seconds, lambda v: v > 0.0),
            (
                "pool_window_stride_seconds",
                runtime.pool_window_stride_seconds,
                lambda v: v > 0.0,
            ),
            (
                "post_hysteresis_enter_confidence",
                runtime.post_hysteresis_enter_confidence,
                lambda v: 0.0 <= v <= 1.0,
            ),
            (
                "post_hysteresis_exit_confidence",
                runtime.post_hysteresis_exit_confidence,
                lambda v: 0.0 <= v <= 1.0,
            ),
            (
                "post_min_segment_duration_seconds",
                runtime.post_min_segment_duration_seconds,
                lambda v: v >= 0.0,
            ),
        )
        for name, value, predicate in runtime_values:
            if not math.isfinite(value) or not predicate(value):
                findings.append(
                    _blocking_config(
                        "invalid_configuration",
                        f"Invalid {profile_name} runtime setting {name}={value!r}.",
                    )
                )
        if runtime.pool_window_stride_seconds > runtime.pool_window_size_seconds:
            findings.append(
                _blocking_config(
                    "invalid_configuration",
                    f"{profile_name} pooling stride cannot exceed its window size.",
                )
            )
        if (
            runtime.max_timeout_retries < 0
            or runtime.max_transient_retries < 0
            or runtime.post_smoothing_window_frames <= 0
        ):
            findings.append(
                _blocking_config(
                    "invalid_configuration",
                    f"{profile_name} retry/smoothing counts are invalid.",
                )
            )

    if (
        settings.training.random_state < 0
        or settings.nn.random_state < 0
        or settings.audio_read.max_retries <= 0
        or settings.data_loader.max_workers <= 0
        or settings.data_loader.max_failed_files < 0
        or settings.data_loader.max_failures_per_reason < 0
        or settings.data_loader.min_remaining_per_class_split < 0
        or settings.medium_training.max_windows_per_clip < 0
    ):
        findings.append(
            _blocking_config(
                "invalid_configuration",
                "Training seeds, retries, workers, iterations, and budgets are invalid.",
            )
        )

    if (
        settings.nn.max_iter <= 0
        or any(size <= 0 for size in settings.nn.hidden_layer_sizes)
    ):
        findings.append(
            _blocking_config(
                "invalid_configuration",
                "Classifier iteration counts and layer sizes must be positive.",
            )
        )

    requested_device = settings.torch_runtime.device.split(":", 1)[0].lower()
    if (
        requested_device not in _ALLOWED_DEVICE_SELECTORS
        or settings.torch_runtime.dtype not in _ALLOWED_DTYPE_SELECTORS
    ):
        findings.append(
            _blocking_config(
                "invalid_configuration", "Runtime device/dtype selector is unsupported."
            )
        )

    try:
        QuarantinePolicy.from_settings(settings)
    except ValueError as error:
        findings.append(_blocking_config("invalid_configuration", str(error)))
    return findings


def _allowed_media_roots(settings: AppConfig) -> tuple[Path, ...]:
    """Canonical roots manifest media paths may inhabit.

    Reference semantics (``training_readiness.py:1245-1256``): registered
    dataset roots when a registry exists, else the configured dataset folder
    plus each manifest's parent directory.
    """
    from ser_tpu_torch._internal.data import registry

    try:
        entries = registry.list_registered_datasets(settings=settings)
    except Exception:  # noqa: BLE001 - registry defects surface in their own check
        entries = []
    roots = {Path(e.dataset_root).expanduser() for e in entries}
    # Unlike the reference, the configured glob folder stays allowed even when
    # a registry exists — a registered corpus must not block training on an
    # unregistered local folder the user explicitly configured.
    roots.add(settings.dataset.folder.expanduser())
    roots.update(Path(p).expanduser().parent for p in settings.dataset.manifest_paths)
    return tuple(sorted(roots, key=str))


def _media_integrity_findings(
    records: list[FileRecord], settings: AppConfig
) -> tuple[list[ReadinessFinding], list[FileRecord]]:
    """Blocking manifest-integrity checks that precede any decode.

    Two defects poison training silently if admitted, so both block as in the
    reference (``training_readiness.py:1441-1540``): a media path that escapes
    every allowed dataset root (a tampered or mis-rooted manifest), and two
    records that resolve to the same file (a path alias double-counts a clip
    and can leak it across speaker-disjoint splits).
    """
    findings: list[ReadinessFinding] = []
    passed: list[FileRecord] = []
    allowed = [root.resolve() for root in _allowed_media_roots(settings)]
    seen_paths: dict[str, str] = {}
    for record in records:
        resolved = Path(record.path).expanduser().resolve()
        if allowed and not any(resolved.is_relative_to(root) for root in allowed):
            findings.append(
                ReadinessFinding(
                    FindingScope.MEDIA,
                    FindingSeverity.BLOCKING,
                    FailureReasonCode.MANIFEST_INVALID.value,
                    f"Media path escapes every allowed dataset root: {record.path}",
                    sample_id=record.path,
                )
            )
            continue
        key = str(resolved)
        if key in seen_paths:
            findings.append(
                ReadinessFinding(
                    FindingScope.MEDIA,
                    FindingSeverity.BLOCKING,
                    FailureReasonCode.PATH_ALIAS.value,
                    (
                        f"Records {seen_paths[key]!r} and {record.path!r} resolve "
                        "to the same media file."
                    ),
                    sample_id=record.path,
                )
            )
            continue
        seen_paths[key] = record.path
        passed.append(record)
    return findings, passed


def _media_findings(
    records: list[FileRecord], settings: AppConfig
) -> tuple[list[ReadinessFinding], list[FileRecord], list[FileRecord], list[str]]:
    """Probes each file's decodability; applies the full quarantine taxonomy.

    Probes run on a bounded thread pool (the data-loader's worker budget —
    audio decode releases the GIL in the native fast path), and each usable
    clip's normalized-PCM digest is captured from the ALREADY-decoded audio
    so prepared plans do not re-decode the corpus. Returns findings,
    quarantined records, usable records, and usable digests (aligned).
    """
    from concurrent.futures import ThreadPoolExecutor

    findings, records = _media_integrity_findings(records, settings)
    quarantined: list[FileRecord] = []
    usable: list[FileRecord] = []
    usable_digests: list[str] = []
    per_reason: Counter[str] = Counter()
    probe_config = dataclasses.replace(
        settings.audio_read, max_retries=1, retry_delay_seconds=0.0
    )

    allowed_roots = _allowed_media_roots(settings)

    def attempt(record: FileRecord):
        from ser_tpu_torch._internal.utils.audio_io import AudioDecodeError

        audio, sr = read_audio_file(record.path, audio_read_config=probe_config)
        if audio.size < int(0.1 * sr):
            raise AudioDecodeError(f"clip shorter than 100 ms: {record.path}")
        return normalized_pcm_sha256(audio)

    def probe(record: FileRecord):
        try:
            return record, attempt(record), None
        except Exception as err:  # noqa: BLE001 - every defect gets classified
            classification = classify_failure(
                err,
                scope=FailureScope.SAMPLE,
                sample_path=record.path,
                allowed_roots=allowed_roots,
            )
            if classification.disposition is FailureDisposition.BOUNDED_RETRY:
                try:
                    return record, attempt(record), None
                except Exception as retry_err:  # noqa: BLE001 - budget exhausted
                    classification = dataclasses.replace(
                        classify_failure(
                            retry_err,
                            scope=FailureScope.SAMPLE,
                            sample_path=record.path,
                            allowed_roots=allowed_roots,
                        ),
                        # The bounded retry is spent: a still-transient error
                        # quarantines rather than retrying forever.
                        disposition=FailureDisposition.QUARANTINE,
                    )
            return record, None, classification

    max_workers = max(1, int(getattr(settings.data_loader, "max_workers", 1) or 1))
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        results = list(pool.map(probe, records))  # preserves input order

    for record, digest, classification in results:
        if classification is None:
            usable.append(record)
            usable_digests.append(digest)
            continue
        if classification.disposition is FailureDisposition.ABORT:
            findings.append(
                ReadinessFinding(
                    FindingScope.MEDIA,
                    FindingSeverity.BLOCKING,
                    classification.reason_code.value,
                    f"{record.path}: {classification.diagnostic}",
                    sample_id=record.path,
                )
            )
            continue
        per_reason[classification.reason_code.value] += 1
        quarantined.append(record)
        findings.append(
            ReadinessFinding(
                FindingScope.MEDIA,
                FindingSeverity.WARNING,
                classification.reason_code.value,
                f"{record.path}: {classification.diagnostic}",
                sample_id=record.path,
            )
        )

    findings.extend(
        _quarantine_budget_findings(
            records, quarantined, per_reason, QuarantinePolicy.from_settings(settings)
        )
    )
    return findings, quarantined, usable, usable_digests


def _quarantine_budget_findings(
    records: list[FileRecord],
    quarantined: list[FileRecord],
    per_reason: Counter,
    policy: QuarantinePolicy,
) -> list[ReadinessFinding]:
    """Evaluates every budget class against one quarantine outcome."""
    findings: list[ReadinessFinding] = []
    total = len(records)
    if not total or not quarantined:
        return findings

    def block(reason: str, message: str) -> None:
        findings.append(
            ReadinessFinding(FindingScope.MEDIA, FindingSeverity.BLOCKING, reason, message)
        )

    if policy.strict:
        block(
            "quarantine_strict",
            f"Strict quarantine mode refuses {len(quarantined)} excluded file(s).",
        )
    if len(quarantined) > policy.max_absolute:
        block(
            "quarantine_budget_absolute",
            f"{len(quarantined)} quarantined files exceed the absolute budget "
            f"({policy.max_absolute}).",
        )
    elif len(quarantined) / total > policy.max_global_ratio:
        block(
            "quarantine_budget_ratio",
            f"Failure ratio {len(quarantined) / total:.1%} exceeds "
            f"{policy.max_global_ratio:.1%}.",
        )

    corpus_totals = Counter(record.corpus for record in records)
    for corpus, lost in Counter(record.corpus for record in quarantined).items():
        ratio = lost / corpus_totals[corpus]
        if ratio > policy.max_corpus_ratio:
            block(
                "quarantine_budget_per_corpus",
                f"Corpus {corpus!r} loses {ratio:.1%} of its files "
                f"(> {policy.max_corpus_ratio:.1%}): exclusion would bias it.",
            )

    class_totals = Counter(r.label for r in records if r.label is not None)
    lost_by_class = Counter(r.label for r in quarantined if r.label is not None)
    for label, lost in lost_by_class.items():
        ratio = lost / class_totals[label]
        if ratio > policy.max_class_ratio:
            block(
                "quarantine_budget_per_class",
                f"Class {label!r} loses {ratio:.1%} of its samples "
                f"(> {policy.max_class_ratio:.1%}): exclusion would bias it.",
            )
        if class_totals[label] - lost < policy.min_remaining_per_class_split:
            block(
                "quarantine_min_remaining",
                f"Class {label!r} would keep only {class_totals[label] - lost} "
                f"sample(s) (< {policy.min_remaining_per_class_split}).",
            )

    for reason, count in per_reason.items():
        if count > policy.max_per_reason:
            block(
                "quarantine_budget_per_reason",
                f"{count} failures of kind {reason} exceed per-reason budget "
                f"({policy.max_per_reason}).",
            )
    return findings


def _split_findings(
    usable: list[FileRecord], settings: AppConfig
) -> list[ReadinessFinding]:
    findings = []
    # Labels come from the attribution pass (manifest-aware); a manifest
    # corpus whose filenames are not RAVDESS-coded must not be blocked for
    # "insufficient classes" it plainly has.
    labeled = [record.label for record in usable if record.label is not None]
    counts = Counter(labeled)
    if len(counts) < 2:
        findings.append(
            ReadinessFinding(
                FindingScope.SPLIT,
                FindingSeverity.BLOCKING,
                "insufficient_classes",
                f"Need >= 2 emotion classes; found {sorted(counts)}.",
            )
        )
    floor = settings.data_loader.min_remaining_per_class_split
    for label, count in sorted(counts.items()):
        if count < max(2, floor + 1):
            findings.append(
                ReadinessFinding(
                    FindingScope.SPLIT,
                    FindingSeverity.WARNING,
                    "class_floor",
                    f"Class {label!r} has only {count} usable clips.",
                )
            )
    speakers = {
        record.speaker or Path(record.path).stem for record in usable
    }
    if len(speakers) < 2:
        findings.append(
            ReadinessFinding(
                FindingScope.SPLIT,
                FindingSeverity.WARNING,
                "single_speaker",
                "Fewer than 2 speakers; speaker-disjoint evaluation degenerates.",
            )
        )
    return findings


def _registry_findings(settings: AppConfig) -> list[ReadinessFinding]:
    """Registered-dataset health as readiness findings.

    Reference ``training_readiness.py:1226-1243`` — a registry entry with a
    missing root/manifest or a count-skewed manifest blocks training rather
    than silently shrinking the corpus at load time.
    """
    from ser_tpu_torch._internal.data.registry import audit_registry_health

    try:
        issues = audit_registry_health(settings=settings)
    except Exception as err:  # noqa: BLE001 - a broken registry is a finding
        return [
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "registry_unreadable",
                f"Dataset registry unreadable: {err}",
            )
        ]
    return [
        ReadinessFinding(
            FindingScope.CONFIG,
            FindingSeverity.BLOCKING,
            f"registry_{issue.issue_kind}",
            f"{issue.dataset_id}: {issue.message}",
        )
        for issue in issues
    ]


def _restricted_backend_findings(
    settings: AppConfig, profile: ProfileName
) -> list[ReadinessFinding]:
    """License-policy validation BEFORE any backend construction.

    Reference ``training_readiness.py:1195-1223`` — an accurate-research run
    without restricted-backend consent must fail in readiness, not after
    minutes of data preparation.
    """
    if profile != "accurate-research":
        return []
    from ser_tpu_torch._internal.runtime.restricted_backends import (
        RestrictedBackendError,
        ensure_backend_access,
    )

    try:
        ensure_backend_access("emotion2vec", settings=settings)
    except (RestrictedBackendError, OSError, ValueError) as err:
        return [
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "restricted_backend_access",
                str(err),
            )
        ]
    return []


def _probe_directory(path: Path) -> None:
    """Write + atomic-rename probe without retaining artifacts.

    Reference ``training_readiness.py:1740-1762``: training persists
    artifacts via temp-file rename, so a filesystem that forbids either
    operation must surface here, not at the final checkpoint write.
    """
    import os
    import tempfile

    target = path.expanduser()
    existing = target
    while not existing.exists() and existing != existing.parent:
        existing = existing.parent
    if not existing.is_dir() or not os.access(existing, os.W_OK):
        raise OSError(f"Required path parent is not writable: {path}")
    probe_dir = target if target.is_dir() else existing
    descriptor, raw = tempfile.mkstemp(prefix=".ser-write-probe-", dir=probe_dir)
    source = Path(raw)
    renamed = source.with_suffix(".renamed")
    try:
        os.write(descriptor, b"ser")
        os.fsync(descriptor)
        os.close(descriptor)
        descriptor = -1
        os.replace(source, renamed)
    finally:
        if descriptor >= 0:
            os.close(descriptor)
        source.unlink(missing_ok=True)
        renamed.unlink(missing_ok=True)


def _resource_findings(settings: AppConfig, sample_count: int) -> list[ReadinessFinding]:
    """Filesystem/OS resource probes scaled to the corpus size.

    Reference ``training_readiness.py:1764-1837``: writability probes on
    every owned output root, a conservative disk estimate (~4 MiB/sample of
    cache + artifacts, doubled), the file-descriptor soft limit against the
    loader's worker fan-out, and available physical memory (~2 MiB/sample).
    """
    import os
    import resource as resource_module
    import shutil

    findings: list[ReadinessFinding] = []
    for path in sorted({settings.models.folder, Path(settings.tmp_folder)}, key=str):
        try:
            _probe_directory(Path(path))
        except OSError as err:
            findings.append(
                ReadinessFinding(
                    FindingScope.RESOURCE,
                    FindingSeverity.BLOCKING,
                    "output_unwritable",
                    str(err),
                )
            )

    tmp_parent = Path(settings.tmp_folder)
    while not tmp_parent.exists() and tmp_parent != tmp_parent.parent:
        tmp_parent = tmp_parent.parent
    free_bytes = shutil.disk_usage(tmp_parent).free
    estimated = max(128 * 1024 * 1024, sample_count * 4 * 1024 * 1024)
    if free_bytes < estimated * 2:
        findings.append(
            ReadinessFinding(
                FindingScope.RESOURCE,
                FindingSeverity.BLOCKING,
                "disk_space_low",
                f"Available disk ({free_bytes} bytes) is below the conservative "
                f"requirement ({estimated * 2} bytes) for {sample_count} samples.",
            )
        )

    try:
        soft_fd_limit, _ = resource_module.getrlimit(resource_module.RLIMIT_NOFILE)
    except (OSError, ValueError):  # pragma: no cover - platform-specific
        soft_fd_limit = resource_module.RLIM_INFINITY
    required_fds = max(64, settings.data_loader.max_workers * 4)
    if soft_fd_limit != resource_module.RLIM_INFINITY and soft_fd_limit < required_fds:
        findings.append(
            ReadinessFinding(
                FindingScope.RESOURCE,
                FindingSeverity.BLOCKING,
                "fd_limit_low",
                f"File descriptor limit {soft_fd_limit} is below required {required_fds}.",
            )
        )

    try:
        available_memory = int(os.sysconf("SC_AVPHYS_PAGES")) * int(os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, TypeError):  # pragma: no cover - platform-specific
        available_memory = 0
    required_memory = max(512 * 1024 * 1024, sample_count * 2 * 1024 * 1024)
    if available_memory and available_memory < required_memory:
        findings.append(
            ReadinessFinding(
                FindingScope.RESOURCE,
                FindingSeverity.BLOCKING,
                "memory_low",
                f"Available memory {available_memory} is below the conservative "
                f"requirement {required_memory}.",
            )
        )
    return findings


def run_training_readiness(
    *, settings: AppConfig, profile: ProfileName
) -> ReadinessReport:
    """Runs the full readiness contract for one profile."""
    findings = _config_findings(settings)
    findings.extend(_restricted_backend_findings(settings, profile))
    findings.extend(_registry_findings(settings))
    if any(f.severity is FindingSeverity.BLOCKING for f in findings):
        return ReadinessReport(profile, tuple(findings), (), ())
    files = loader.discover_dataset_files(settings)
    if not files:
        findings.append(
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "no_dataset_files",
                f"No files matched {settings.dataset.glob_pattern}.",
            )
        )
        return ReadinessReport(profile, tuple(findings), (), ())
    findings.extend(_resource_findings(settings, len(files)))
    if any(f.severity is FindingSeverity.BLOCKING for f in findings):
        return ReadinessReport(profile, tuple(findings), (), ())
    media, quarantined, usable, digests = _media_findings(
        _file_records(files, settings), settings
    )
    findings.extend(media)
    findings.extend(_split_findings(usable, settings))
    findings.extend(_recipe_findings(settings))
    return ReadinessReport(
        profile,
        tuple(findings),
        tuple(record.path for record in quarantined),
        tuple(record.path for record in usable),
        usable_records=tuple(usable),
        usable_digests=tuple(digests),
    )


# --------------------------------------------------------------------------- #
# Selected-backend smoke (hard wall-clock deadline)
# --------------------------------------------------------------------------- #


@contextmanager
def _smoke_deadline(seconds: float):
    """Hard SIGALRM deadline (reference ``training_orchestration.py:458-476``).

    A hung backend (deadlocked compile, stuck IO) must not stall training
    forever; a soft thread timeout cannot interrupt native code, so the smoke
    runs under a real timer when the platform/thread supports one.
    """
    import signal
    import threading

    can_alarm = (
        threading.current_thread() is threading.main_thread()
        and hasattr(signal, "SIGALRM")
        and hasattr(signal, "ITIMER_REAL")
    )
    if not can_alarm:
        yield  # soft path: the exception contract still holds, minus the timer
        return
    previous = signal.getsignal(signal.SIGALRM)

    def _timeout(_signum, _frame):
        raise TimeoutError(f"Backend smoke exceeded {seconds:.1f}s wall clock.")

    signal.signal(signal.SIGALRM, _timeout)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, previous)


def _smoke_default_timeout(settings: AppConfig) -> float:
    """The smoke deadline's default, from the settings' resolved torch device.

    The deadline exists to catch hangs, but on the card the smoke's first
    encode in a process also builds the CUDA kernels with ``nvcc`` and places
    the full-width encoder's weights, so the card gets 420 s and the CPU
    120 s; ``SER_TRAINING_SMOKE_TIMEOUT_SECONDS`` overrides either.
    """
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device

    try:
        on_card = resolve_device(settings.torch_runtime.device).type == "cuda"
    except (RuntimeError, ValueError):  # no card: the smoke itself reports it
        on_card = False
    return 420.0 if on_card else 120.0


def _smoke_timeout_seconds(settings: AppConfig) -> float:
    raw = os.environ.get("SER_TRAINING_SMOKE_TIMEOUT_SECONDS")
    if raw is None:
        return _smoke_default_timeout(settings)
    try:
        seconds = float(raw)
    except ValueError as err:
        raise ValueError("SER_TRAINING_SMOKE_TIMEOUT_SECONDS must be numeric.") from err
    if not np.isfinite(seconds) or not 0.0 < seconds <= 600.0:
        raise ValueError("SER_TRAINING_SMOKE_TIMEOUT_SECONDS must be in (0, 600].")
    return seconds


#: Upper bound on smoke probes per run (reference ``training_readiness.py:52``).
DEFAULT_SMOKE_SAMPLE_CAP = 16


def select_smoke_samples(
    records: Sequence[FileRecord], *, cap: int = DEFAULT_SMOKE_SAMPLE_CAP
) -> tuple[FileRecord, ...]:
    """Deterministic bounded selection covering corpus/format/language strata.

    Reference semantics (``training_readiness.py:637-703``): one lexicographic
    representative per (corpus, suffix, language) stratum — every corpus and
    container format must decode through the REAL backend before training —
    then remaining capacity fills with the lowest (label, language, corpus,
    path) coverage keys. More strata than ``cap`` is an error: a smoke that
    cannot cover its inputs proves nothing.
    """
    if cap <= 0:
        raise ValueError("Smoke sample cap must be positive.")
    strata: dict[tuple[str, str, str], FileRecord] = {}
    for record in records:
        suffix = Path(record.path).suffix.lower() or "<none>"
        stratum = (record.corpus, suffix, record.language or "<none>")
        representative = strata.get(stratum)
        if representative is None:
            if len(strata) == cap:
                raise ValueError(
                    "Smoke sample cap cannot cover every required "
                    f"corpus/format/language stratum: required>{cap} cap={cap}."
                )
            strata[stratum] = record
        elif record.path < representative.path:
            strata[stratum] = record

    selected = [strata[key] for key in sorted(strata)]
    seen = {record.path for record in selected}
    coverage = sorted(
        (r for r in records if r.path not in seen),
        key=lambda r: (r.label or "", r.language or "", r.corpus, r.path),
    )
    for record in coverage:
        if len(selected) == cap:
            break
        if record.path in seen:
            continue
        selected.append(record)
        seen.add(record.path)
    return tuple(selected[:cap])


def run_backend_smoke(
    *,
    settings: AppConfig,
    profile: ProfileName,
    usable_files: tuple[str, ...],
    usable_records: tuple[FileRecord, ...] = (),
    backend=None,
) -> list[ReadinessFinding]:
    """Encodes real clips through the selected backend before training.

    Proves the full feature path (decode → encode → finite features of the
    expected dimension) under a hard deadline; any defect becomes a BLOCKING
    resource finding rather than a mid-training crash. ``backend`` carries an
    injected double through (the designed test seam) — the smoke must probe
    what training will actually use. With corpus attribution available
    (``usable_records``), a stratified sample matrix covers every
    corpus/format/language stratum; the bare-files path keeps the historical
    smallest-file single probe.
    """
    if not usable_files:
        return []
    if usable_records:
        try:
            probes = [r.path for r in select_smoke_samples(usable_records)]
        except ValueError as err:
            return [
                ReadinessFinding(
                    FindingScope.CONFIG, FindingSeverity.BLOCKING, "smoke_cap_exceeded", str(err)
                )
            ]
    else:
        try:
            probes = [min(usable_files, key=lambda f: Path(f).stat().st_size)]
        except OSError:
            probes = [usable_files[0]]  # a vanished file still fails inside the smoke
    try:
        timeout = _smoke_timeout_seconds(settings)
    except ValueError as err:
        return [
            ReadinessFinding(
                FindingScope.CONFIG, FindingSeverity.BLOCKING, "smoke_timeout_invalid", str(err)
            )
        ]
    probe = probes[0]
    try:
        # One deadline covers the whole matrix — the budget guards the RUN
        # (reference semantics), and later probes reuse the first compile.
        with _smoke_deadline(timeout):
            for probe in probes:
                audio, sr = read_audio_file(probe, audio_read_config=settings.audio_read)
                if profile == "fast":
                    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
                    from ser_tpu_torch.ops.features import extract_frame_features, feature_dim

                    features, _, _ = extract_frame_features(
                        audio,
                        sr,
                        device=resolve_device(settings.torch_runtime.device),
                        feature_flags=settings.feature_flags,
                    )
                    expected = feature_dim(settings.feature_flags)
                    actual = int(features.shape[1])
                else:
                    if backend is None:
                        from ser_tpu_torch._internal.repr.encoders import build_encoder_backend

                        backend = build_encoder_backend(profile, settings=settings)
                    encoded = backend.encode_sequence(audio, sr)
                    expected = backend.feature_dim
                    actual = int(encoded.embeddings.shape[1])
                    features = encoded.embeddings
                    if isinstance(features, torch.Tensor):  # frames kept on the card (SER_DEVICE_POOLING=1)
                        features = features.float().cpu().numpy()
                if actual != expected:
                    raise ValueError(
                        f"smoke feature dimension violates the classifier contract: "
                        f"expected={expected} actual={actual}"
                    )
                if not np.isfinite(np.asarray(features)).all():
                    raise ValueError("smoke features contain non-finite values")
    except TimeoutError as err:
        return [
            ReadinessFinding(
                FindingScope.RESOURCE,
                FindingSeverity.BLOCKING,
                "backend_smoke_timeout",
                f"{profile} backend smoke on {probe}: {err} "
                "(first-compile latency counts toward the deadline; raise "
                "SER_TRAINING_SMOKE_TIMEOUT_SECONDS if the platform compiles slowly)",
            )
        ]
    except Exception as err:  # noqa: BLE001 - any smoke defect blocks training
        return [
            ReadinessFinding(
                FindingScope.RESOURCE,
                FindingSeverity.BLOCKING,
                "backend_smoke_failed",
                f"{profile} backend smoke on {probe}: {type(err).__name__}: {err}",
            )
        ]
    return [
        ReadinessFinding(
            FindingScope.RESOURCE,
            FindingSeverity.INFO,
            "backend_smoke_ok",
            f"{profile} backend smoke passed on {len(probes)} stratified "
            f"sample(s) (dim={actual}).",
        )
    ]


def _recipe_findings(settings: AppConfig) -> list[ReadinessFinding]:
    """Audits the configured cross-corpus recipe when one is set."""
    if not settings.dataset.recipe:
        return []
    from ser_tpu_torch._internal.data.recipe import audit_recipe, load_dataset_recipe

    try:
        # Built-in recipe id OR a versioned JSON recipe file, like the
        # reference's ``--dataset-recipe`` (``recipe.py:252-313``).
        recipe = load_dataset_recipe(settings.dataset.recipe)
    except (KeyError, ValueError) as err:
        return [
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "unknown_recipe",
                str(err),
            )
        ]
    try:
        utterances = loader.load_utterances(settings=settings)
    except (OSError, RuntimeError, ValueError) as err:
        # Manifest defects (cross-manifest duplicate sample_ids, unreadable
        # files) are FINDINGS — readiness's contract is that every defect
        # surfaces as one, never as a traceback out of --dry-run.
        return [
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "recipe_manifest_invalid",
                f"Recipe configured but manifests failed to load: {err}",
            )
        ]
    if not utterances:
        return [
            ReadinessFinding(
                FindingScope.CONFIG,
                FindingSeverity.BLOCKING,
                "recipe_no_utterances",
                "Recipe configured but no utterances loaded.",
            )
        ]
    report = audit_recipe(utterances, recipe, strict=settings.dataset.strict_audit)
    return [
        ReadinessFinding(
            FindingScope.CONFIG,
            FindingSeverity.BLOCKING if issue.blocking else FindingSeverity.WARNING,
            f"recipe:{issue.kind}",
            issue.message,
        )
        for issue in report.issues
    ]


# --------------------------------------------------------------------------- #
# Prepared plans (digest-signed resume)
# --------------------------------------------------------------------------- #


def _backend_fingerprint(settings: AppConfig, profile: ProfileName) -> dict:
    """Backend identity a prepared plan is only valid for.

    Reference plans bind model revision + device/dtype + cache namespace
    (``training_orchestration.py:842-976``); resuming an accurate plan into a
    medium run (or after a model-id change) must fail digest validation.
    """
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_feature_runtime
    from ser_tpu_torch.profiles import require_ported

    spec = require_ported(profile)
    runtime = resolve_feature_runtime(spec.backend_id, torch_runtime=settings.torch_runtime)
    return {
        "backend_id": spec.backend_id,
        "model_id": spec.default_model_id,
        # "cuda" on the card (the JAX package's "tpu"), "cpu" on the CPU: a plan
        # prepared on one device does not resume on another.
        "device": runtime.device.type,
        "dtype": runtime.dtype,
    }


def recipe_content_digest(settings: AppConfig) -> str:
    """Digest of the configured recipe's CONTENT (reference
    ``training_orchestration.py:183-190`` ``_recipe_digest``): the sha256 of
    the canonical-JSON encoding of the recipe file's text when the knob names
    a file, else of the knob string itself (built-in id or unset → "none").
    Prepared plans pin this so EDITING the recipe file invalidates the plan —
    the settings digest only sees the unchanged path string.
    """
    recipe = settings.dataset.recipe or "none"
    recipe_path = Path(recipe).expanduser()
    # An existing-but-unreadable recipe file propagates its OSError (the
    # reference has no fallback): silently digesting the path string would
    # pin a value that stops tracking the file's content.
    payload: str = (
        recipe_path.read_text(encoding="utf-8") if recipe_path.is_file() else recipe
    )
    canonical = json.dumps(
        payload,
        sort_keys=True,
        separators=(",", ":"),
        ensure_ascii=False,
        allow_nan=False,
    )
    return sha256(canonical.encode("utf-8")).hexdigest()


def _settings_digest(settings: AppConfig, profile: ProfileName) -> str:
    payload = json.dumps(
        {
            "profile": profile,
            "backend": _backend_fingerprint(settings, profile),
            "feature_flags": dataclasses.asdict(settings.feature_flags),
            "nn": dataclasses.asdict(settings.nn),
            "training": dataclasses.asdict(settings.training),
            "emotions": dict(settings.emotions),
        },
        sort_keys=True,
        default=str,
    )
    return sha256(payload.encode("utf-8")).hexdigest()


def _labeled_usable(report: ReadinessReport) -> list[tuple[FileRecord, str]]:
    """(record, digest) for usable files that carry a label.

    Labels/digests come from the readiness attribution + media probe
    (manifest-aware; no re-decode). Reports built before the record fields
    existed fall back to empty — callers then raise their no-clips error.
    """
    if report.usable_records and len(report.usable_digests) == len(report.usable_records):
        return [
            (record, digest)
            for record, digest in zip(report.usable_records, report.usable_digests)
            if record.label is not None
        ]
    return []


def _prepare_fast_features(
    report: ReadinessReport, settings: AppConfig
) -> tuple[np.ndarray, list[str], list[str], list[str], list[str]]:
    from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
    from ser_tpu_torch.ops.features import extract_feature_vectors_batch

    clips, labels, digests, kept_files, groups = [], [], [], [], []
    for record, digest in _labeled_usable(report):
        audio, sr = read_audio_file(record.path, audio_read_config=settings.audio_read)
        clips.append((audio, sr))
        labels.append(record.label)
        digests.append(digest)
        kept_files.append(record.path)
        groups.append(record.speaker or Path(record.path).stem)
    if not clips:
        raise RuntimeError("No usable labeled clips to prepare.")
    features = extract_feature_vectors_batch(
        clips, device=resolve_device(settings.torch_runtime.device), feature_flags=settings.feature_flags
    )
    return features, labels, digests, kept_files, groups


def _prepare_encoder_features(
    report: ReadinessReport, settings: AppConfig, profile: ProfileName
) -> tuple[np.ndarray, list[str], list[str], list[str], list[str]]:
    """Pooled per-window embeddings via the SELECTED backend (profile-aware)."""
    from ser_tpu_torch._internal.models.encoder_training import _windowed_dataset
    from ser_tpu_torch._internal.repr.encoders import build_encoder_backend

    files, digests = [], []
    group_by_path: dict[str, str] = {}
    for record, digest in _labeled_usable(report):
        digests.append(digest)
        files.append((record.path, record.label, record.speaker))
        group_by_path[record.path] = record.speaker or Path(record.path).stem
    if not files:
        raise RuntimeError("No usable labeled clips to prepare.")
    backend = build_encoder_backend(profile, settings=settings)
    runtime_config = settings.profile_runtime(profile)  # type: ignore[arg-type]
    features, labels, sample_ids, _noise_stats = _windowed_dataset(
        files=files,
        backend=backend,
        settings=settings,
        window_size=runtime_config.pool_window_size_seconds,
        window_stride=runtime_config.pool_window_stride_seconds,
    )
    # Per-WINDOW group labels: sibling windows of one clip/speaker must not
    # straddle the resume path's train/test split.
    groups = [group_by_path.get(sample, sample) for sample in sample_ids]
    return features, labels, digests, [f for f, _, _ in files], groups


def _plan_split_salt(settings: AppConfig) -> str:
    from ser_tpu_torch._internal.models.dataset_splitting import split_salt

    return split_salt(settings)


def current_split_digest(settings: AppConfig, profile: ProfileName) -> str:
    """Recomputes :func:`split_digest` from the CURRENT dataset, cheaply.

    Plan-load validation needs split membership without re-running full
    readiness (media probes, backend smoke): discovery + attribution minus
    the profile's quarantine-ledger exclusions reproduces the usable set —
    media probing is content-deterministic and its exclusion set is pinned
    separately by :func:`quarantine_ledger_digest`. Reference:
    ``validate_operation_plan`` recomputes ``_current_split_digest``
    (``training_orchestration.py:212-231``) the same way.
    """
    files = loader.discover_dataset_files(settings)
    records = _file_records(files, settings)
    ledger_path = settings.tmp_folder / "quarantine" / f"{profile}.jsonl"
    excluded = {row.get("file", "") for row in _read_ledger_rows(ledger_path)}
    usable = tuple(r for r in records if r.path not in excluded)
    return split_digest(
        ReadinessReport(profile, (), (), (), usable_records=usable), settings
    )


def split_digest(report: ReadinessReport, settings: AppConfig) -> str:
    """Digest of the deterministic three-way split over the usable samples.

    Parity: reference ``training_orchestration.py:212-231`` — the prepared
    plan must invalidate when split MEMBERSHIP changes, not only when split
    settings change: ``SER_SPLIT_SALT`` lives in the environment (outside the
    settings digest), and a different effective-sample set reshuffles every
    hash-ordered assignment.
    """
    from ser_tpu_torch._internal.data.manifest import Utterance
    from ser_tpu_torch._internal.models.dataset_splitting import split_utterances_three_way

    samples = [
        Utterance(
            sample_id=record.path,
            corpus=record.corpus,
            audio_path=record.path,
            label=record.label,
            speaker_id=record.speaker,
            language=record.language or "en",
        )
        for record in report.usable_records
        if record.label is not None
    ]
    if len(samples) < 2:
        return "insufficient-samples"
    try:
        train, dev, test, metadata = split_utterances_three_way(
            samples=samples, settings=settings
        )
    except (RuntimeError, ValueError) as err:
        return f"split-error:{type(err).__name__}"
    canonical = json.dumps(
        {
            "metadata": metadata.as_dict(),
            "train": sorted(item.sample_id for item in train),
            "dev": sorted(item.sample_id for item in dev),
            "test": sorted(item.sample_id for item in test),
        },
        sort_keys=True,
    )
    return sha256(canonical.encode("utf-8")).hexdigest()


def write_prepared_plan(
    *,
    settings: AppConfig,
    profile: ProfileName,
    report: ReadinessReport,
    plan_dir: Path,
) -> Path:
    """Extracts the PROFILE's features for usable files; digest-signs the plan.

    Fast prepares handcrafted frame features; encoder profiles prepare pooled
    window embeddings through their selected backend, so ``--prepared-plan``
    resume fits the head on exactly what full training would have computed.
    """
    plan_dir.mkdir(parents=True, exist_ok=True)
    if profile == "fast":
        features, labels, digests, kept_files, groups = _prepare_fast_features(
            report, settings
        )
    else:
        features, labels, digests, kept_files, groups = _prepare_encoder_features(
            report, settings, profile
        )

    payload_path = plan_dir / "prepared_features.npz"
    np.savez_compressed(
        payload_path,
        features=features,
        labels=np.asarray(labels, dtype=object),
        groups=np.asarray(groups, dtype=object),
    )
    plan = {
        "plan_schema_version": PLAN_SCHEMA_VERSION,
        "profile": profile,
        "backend": _backend_fingerprint(settings, profile),
        "settings_digest": _settings_digest(settings, profile),
        "quarantine_ledger_digest": quarantine_ledger_digest(settings, profile),
        "split_digest": split_digest(report, settings),
        "split_salt": _plan_split_salt(settings),
        "recipe_digest": recipe_content_digest(settings),
        "files": kept_files,
        "sample_digests": digests,
        "payload": str(payload_path),
        "feature_dim": int(features.shape[1]),
        "rows": int(features.shape[0]),
    }
    plan_path = plan_dir / "prepared_plan.json"
    plan_path.write_text(json.dumps(plan, indent=2), encoding="utf-8")
    return plan_path


def write_quarantine_ledger(
    report: ReadinessReport, *, settings: AppConfig
) -> Path | None:
    """Appends quarantine records to the profile's JSONL ledger.

    Parity surface: reference quarantine ledgers
    (``training_readiness.py:704-864``, ``docs/training-readiness.md:50-60``) —
    every excluded sample is recorded with scope/reason/message so exclusions
    are auditable and stable across prepare/train reruns.
    """
    if not report.quarantined_files:
        return None
    ledger_dir = settings.tmp_folder / "quarantine"
    ledger_dir.mkdir(parents=True, exist_ok=True)
    ledger_path = ledger_dir / f"{report.profile}.jsonl"
    # Findings key by FULL path — stems collide across Actor_* directories
    # and would mis-audit one exclusion's reason onto another.
    media_findings = {
        finding.sample_id: finding
        for finding in report.findings
        if finding.scope is FindingScope.MEDIA and finding.sample_id
    }
    existing = {
        (row.get("file"), row.get("reason"), row.get("message"))
        for row in _read_ledger_rows(ledger_path)
    }
    import time as _time

    with ledger_path.open("a", encoding="utf-8") as handle:
        for file in report.quarantined_files:
            finding = media_findings.get(file)
            row = {
                "file": file,
                "scope": "media",
                "reason": finding.reason if finding else "unknown",
                "message": finding.message if finding else "",
            }
            # Append-only audit trail WITHOUT rerun spam: an identical
            # exclusion already on record is not re-appended (re-appending
            # also churned the plan digest on every dry-run).
            if (row["file"], row["reason"], row["message"]) in existing:
                continue
            handle.write(
                json.dumps({**row, "recorded_at_unix": _time.time()}) + "\n"
            )
    return ledger_path


def _read_ledger_rows(ledger_path: Path) -> list[dict]:
    if not ledger_path.exists():
        return []
    rows = []
    for line in ledger_path.read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rows.append(json.loads(line))
        except ValueError:
            rows.append({"file": line, "scope": "?", "reason": "?", "message": line})
    return rows


def quarantine_ledger_digest(settings: AppConfig, profile: ProfileName) -> str | None:
    """Digest of the profile's CURRENT exclusion set (None when absent).

    Canonicalized over the stable fields (file/scope/reason/message), sorted
    and deduplicated — per-record timestamps and historical duplicates must
    not invalidate a prepared plan whose effective exclusions are unchanged
    (the documented "stable across prepare/train reruns" contract).
    """
    ledger_path = settings.tmp_folder / "quarantine" / f"{profile}.jsonl"
    if not ledger_path.exists():
        return None
    canonical = sorted(
        {
            (
                row.get("file", ""),
                row.get("scope", ""),
                row.get("reason", ""),
                row.get("message", ""),
            )
            for row in _read_ledger_rows(ledger_path)
        }
    )
    return sha256(json.dumps(canonical).encode("utf-8")).hexdigest()


class PreparedPlanError(ValueError):
    """Raised when a prepared plan fails digest validation."""


def load_prepared_plan(
    plan_path: Path, *, settings: AppConfig, profile: ProfileName
) -> tuple[np.ndarray, list[str], list[str] | None]:
    """Validates a prepared plan's digests; returns (features, labels, groups).

    ``groups`` carries per-row speaker/clip ids when the plan's payload has
    them (group-disjoint resume splits), else None.

    Every defect in the plan file or its payload raises
    :class:`PreparedPlanError` (the CLI's documented exit-code-2 surface) —
    a truncated JSON or a missing sibling NPZ must not traceback.
    """
    try:
        plan = json.loads(Path(plan_path).read_text(encoding="utf-8"))
    except (OSError, ValueError) as err:
        raise PreparedPlanError(f"Cannot read prepared plan {plan_path}: {err}") from err
    if not isinstance(plan, dict):
        raise PreparedPlanError("Prepared plan must be a JSON object.")
    if plan.get("plan_schema_version") != PLAN_SCHEMA_VERSION:
        raise PreparedPlanError("Unsupported prepared-plan schema version.")
    if plan.get("profile") != profile:
        raise PreparedPlanError(
            f"Plan was prepared for profile {plan.get('profile')!r}, not {profile!r}."
        )
    if plan.get("settings_digest") != _settings_digest(settings, profile):
        raise PreparedPlanError(
            "Prepared plan settings digest mismatch: training configuration changed "
            "since preparation. Re-run --prepare-only."
        )
    if plan.get("quarantine_ledger_digest") != quarantine_ledger_digest(settings, profile):
        raise PreparedPlanError(
            "Prepared plan quarantine-ledger digest mismatch: exclusions changed "
            "since preparation. Re-run --prepare-only."
        )
    # SER_SPLIT_SALT lives in the environment, outside the settings digest —
    # a salt change reshuffles split membership and must invalidate the plan
    # (reference training_orchestration.py:212-231 recomputes the split
    # digest; the salt is its only input not already pinned here).
    if plan.get("split_salt") != _plan_split_salt(settings):
        # Unconditional like the recipe pin below: a plan WITHOUT the field
        # is equally unverifiable.
        raise PreparedPlanError(
            "Prepared plan split salt mismatch: SER_SPLIT_SALT changed since "
            "preparation (or the plan predates salt pinning). Re-run "
            "--prepare-only."
        )
    # Recipe CONTENT pin (reference validate_prepared_plan recomputes
    # _recipe_digest, training_orchestration.py:1367): an edited recipe file
    # changes routing/splits without touching any settings value. A plan
    # WITHOUT the field (pre-pin writer, or hand-stripped) is equally
    # unverifiable — the reference always compares, never skips. An
    # unreadable recipe file is a plan-validation defect, not a traceback
    # (the CLI's contract is PreparedPlanError -> exit 2).
    try:
        current_recipe_digest = recipe_content_digest(settings)
    except OSError as err:
        raise PreparedPlanError(
            f"Prepared plan recipe digest could not be recomputed: {err}. "
            "Re-run --prepare-only."
        ) from err
    if plan.get("recipe_digest") != current_recipe_digest:
        raise PreparedPlanError(
            "Prepared plan recipe digest mismatch: the dataset recipe changed "
            "since preparation (or the plan predates recipe pinning). "
            "Re-run --prepare-only."
        )
    # Split MEMBERSHIP pin (split_digest's own contract; the reference's
    # validate_operation_plan recomputes it): files added to or removed from
    # the dataset reshuffle the deterministic split even though no settings
    # value changes. Recomputed from a light discovery+attribution scan.
    try:
        expected_split = current_split_digest(settings, profile)
    except (OSError, RuntimeError, ValueError) as err:
        raise PreparedPlanError(
            f"Prepared plan split digest could not be recomputed: {err}. "
            "Re-run --prepare-only."
        ) from err
    if plan.get("split_digest") != expected_split:
        raise PreparedPlanError(
            "Prepared plan split digest mismatch: dataset membership changed "
            "since preparation. Re-run --prepare-only."
        )
    expected_backend = _backend_fingerprint(settings, profile)
    if plan.get("backend") != expected_backend:
        raise PreparedPlanError(
            f"Prepared plan backend fingerprint {plan.get('backend')} does not match "
            f"the active runtime {expected_backend}. Re-run --prepare-only."
        )
    payload_path = plan.get("payload")
    if not payload_path:
        raise PreparedPlanError("Prepared plan names no feature payload.")
    try:
        with np.load(payload_path, allow_pickle=True) as payload:
            features = payload["features"]
            labels = [str(label) for label in payload["labels"]]
            groups = (
                [str(group) for group in payload["groups"]]
                if "groups" in payload
                else None
            )
    except (OSError, KeyError, ValueError) as err:
        raise PreparedPlanError(
            f"Prepared feature payload {payload_path} is missing or unreadable: {err}. "
            "Re-run --prepare-only."
        ) from err
    if len(plan.get("files", ())) != len(plan.get("sample_digests", ())):
        raise PreparedPlanError("Prepared plan file/digest lists are inconsistent.")
    if features.shape[0] != plan.get("rows", features.shape[0]):
        raise PreparedPlanError("Prepared payload row count does not match the plan.")
    if groups is not None and len(groups) != features.shape[0]:
        raise PreparedPlanError("Prepared payload group list is inconsistent.")
    return features, labels, groups


def default_readiness_report_path(settings: AppConfig, profile: ProfileName) -> Path:
    """Readiness-report location (reference ``training_readiness.py:870-873``:
    ``<tmp>/training-readiness-<profile>.json``)."""
    return settings.tmp_folder / f"training-readiness-{profile}.json"


def write_readiness_report(
    report: ReadinessReport, *, settings: AppConfig
) -> Path:
    """Atomically persists the readiness report JSON for audit/tooling.

    Parity: the reference persists every readiness run to the default path
    via write-temp + rename (its repair catalog cleans the
    ``.training-readiness-*`` staging remnants — mirrored in
    ``training_repair._STAGING_PATTERNS``).
    """
    import tempfile

    target = default_readiness_report_path(settings, report.profile)
    target.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "profile": report.profile,
        "blocking": report.blocking,
        "findings": [
            {
                "scope": finding.scope.value,
                "severity": finding.severity.value,
                "reason": finding.reason,
                "message": finding.message,
                "sample_id": finding.sample_id,
            }
            for finding in report.findings
        ],
        "usable_files": list(report.usable_files),
        "quarantined_files": list(report.quarantined_files),
        "generated_at_unix": time.time(),
    }
    fd, tmp_name = tempfile.mkstemp(
        dir=target.parent, prefix=f".training-readiness-{report.profile}."
    )
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as handle:
            json.dump(payload, handle, indent=2, default=str)
        os.replace(tmp_name, target)
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise
    return target


def run_training_readiness_cli(
    *,
    settings: AppConfig,
    profile: ProfileName,
    dry_run: bool,
    prepare_only: bool,
    prepared_plan: str | None,
) -> int:
    """CLI entry for --dry-run / --prepare-only / --prepared-plan flows."""
    if prepared_plan:
        from ser_tpu_torch._internal.models.fast_training import train_from_prepared

        try:
            report = train_from_prepared(
                plan_path=Path(prepared_plan), settings=settings, profile=profile
            )
        except PreparedPlanError as err:
            logger.error("%s", err)
            return 2
        print(f"Trained from prepared plan: accuracy={report['accuracy']:.3f}")
        return 0

    report = run_training_readiness(settings=settings, profile=profile)
    report_path = write_readiness_report(report, settings=settings)
    print(f"readiness report: {report_path}")
    ledger = write_quarantine_ledger(report, settings=settings)
    if ledger is not None:
        print(f"quarantine ledger: {ledger}")
    for finding in report.findings:
        print(f"[{finding.severity.value:>8}] {finding.scope.value}/{finding.reason}: {finding.message}")
    print(
        f"usable={len(report.usable_files)} quarantined={len(report.quarantined_files)} "
        f"blocking={report.blocking}"
    )
    if report.blocking:
        return 2
    if prepare_only:
        plan_dir = settings.tmp_folder / "prepared" / profile
        plan_path = write_prepared_plan(
            settings=settings, profile=profile, report=report, plan_dir=plan_dir
        )
        print(f"Prepared plan written: {plan_path}")
    return 0


__all__ = [
    "FileRecord",
    "FindingScope",
    "FindingSeverity",
    "PreparedPlanError",
    "QuarantinePolicy",
    "ReadinessFinding",
    "ReadinessReport",
    "default_readiness_report_path",
    "load_prepared_plan",
    "run_backend_smoke",
    "select_smoke_samples",
    "DEFAULT_SMOKE_SAMPLE_CAP",
    "FailureScope",
    "FailureDisposition",
    "FailureReasonCode",
    "FailureClassification",
    "classify_failure",
    "WindowContainmentError",
    "CacheEntryCorruptError",
    "OptionalArtifactError",
    "run_training_readiness",
    "run_training_readiness_cli",
    "write_prepared_plan",
    "write_readiness_report",
]
