"""Training run orchestration: the run state, readiness gating, contained failures.

Counterpart of ``ser_tpu/_internal/models/training_orchestration.py``:
``TrainingRunState`` scoped by a ``ContextVar`` (the loader stamps the
audited recipe's digests on it for the artifact's metadata); the entry
points' readiness gate (``ensure_entrypoint_readiness``: readiness, then the
selected backend's smoke under its deadline, the report persisted, blocking
findings raised as ``TrainingNotReadyError``); the bounded retry of typed
transient local I/O with jitter from the sample's digest; the mid-training
quarantine of a sample that vanished or went corrupt after readiness, only
while every budget still holds (``QuarantineBudgetExceeded`` otherwise); and
the embedding cache's probe counts.
"""

from __future__ import annotations

import time
import uuid
from collections import Counter
from collections.abc import Callable, Iterator
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import TypeVar

from ser_tpu_torch._internal.config.schema import AppConfig
from ser_tpu_torch._internal.models.training_readiness import (
    FailureDisposition,
    FailureScope,
    QuarantinePolicy,
    ReadinessReport,
    classify_failure,
    run_training_readiness,
)
from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.profiles import ProfileName

_OperationT = TypeVar("_OperationT")

logger = get_logger(__name__)


class TrainingNotReadyError(RuntimeError):
    """Raised when blocking readiness findings prevent training."""


@dataclass
class TrainingRunState:
    """Mutable state for one training operation scope.

    The containment counters mirror the reference's run-state bookkeeping
    (``training_orchestration.py:577-650``): every classified failure that
    was CONTAINED (rather than aborting) leaves an auditable
    ``scope:reason:disposition`` count in the training report.
    """

    operation_id: str
    profile: ProfileName
    started_at_unix: float
    phase: str = "pending"
    readiness: ReadinessReport | None = None
    notes: list[str] = field(default_factory=list)
    containment_counts: Counter = field(default_factory=Counter)
    cache_hits: int = 0
    cache_misses: int = 0
    bounded_retries: int = 0
    quarantined_sample_paths: list[str] = field(default_factory=list)
    # Audited-recipe provenance, set by loader.apply_recipe_ledger and
    # stamped into artifact metadata (reference v3 fields,
    # artifact_metadata.py:231-234 validates them at load when present).
    recipe_digest: str | None = None
    split_ledger_digest: str | None = None


_active_run: ContextVar[TrainingRunState | None] = ContextVar(
    "ser_tpu_torch_training_run", default=None
)


def current_training_run() -> TrainingRunState | None:
    """The active training run state, when inside a scope."""
    return _active_run.get()


class QuarantineBudgetExceeded(RuntimeError):
    """A training-time quarantine would exceed the configured budgets."""


def _record_containment(scope: str, reason: str, disposition: str) -> None:
    state = current_training_run()
    if state is not None:
        state.containment_counts[f"{scope}:{reason}:{disposition}"] += 1


def record_cache_probe(*, hit: bool) -> None:
    """Counts one embedding-cache probe in the active run state."""
    state = current_training_run()
    if state is None:
        return
    if hit:
        state.cache_hits += 1
    else:
        state.cache_misses += 1


def bounded_retry_local_io(
    operation: Callable[[], _OperationT],
    *,
    identity: str,
    max_retries: int = 2,
    base_delay_seconds: float = 0.05,
) -> _OperationT:
    """Retries only typed transient local I/O with deterministic jitter.

    Reference semantics (``training_orchestration.py:617-650``): the retry
    privilege is PROVEN by ``classify_failure`` returning BOUNDED_RETRY —
    corrupt audio or unknown defects re-raise immediately. Jitter derives
    from the sample identity digest so reruns are bit-reproducible.
    """
    import hashlib

    if max_retries < 0 or base_delay_seconds < 0.0:
        raise ValueError("Retry bounds must be non-negative.")
    for attempt in range(max_retries + 1):
        try:
            return operation()
        except OSError as error:
            classification = classify_failure(error, scope=FailureScope.SAMPLE)
            if (
                classification.disposition is not FailureDisposition.BOUNDED_RETRY
                or attempt >= max_retries
            ):
                raise
            state = current_training_run()
            if state is not None:
                state.bounded_retries += 1
            _record_containment("sample", "media_decode_failed", "bounded_retry")
            digest = hashlib.sha256(identity.encode("utf-8")).hexdigest()
            jitter = 0.75 + (int(digest[:8], 16) % 501) / 1000.0
            delay = base_delay_seconds * (2**attempt) * jitter
            logger.warning(
                "Retrying transient local I/O attempt=%d/%d delay=%.3fs identity=%s",
                attempt + 1,
                max_retries,
                delay,
                identity,
            )
            time.sleep(delay)
    raise AssertionError("unreachable: retry loop always returns or raises")


def handle_sample_encoding_failure(
    *,
    settings: AppConfig,
    sample_path: str,
    label: str | None,
    error: Exception,
    all_labels: list[str | None],
    quarantined_labels: list[str | None],
) -> bool:
    """Quarantines one proven per-sample failure only when every budget permits.

    Reference semantics (``training_orchestration.py:715-790``): a sample that
    vanished or went corrupt BETWEEN readiness and training may be dropped —
    but only if the projected dataset still satisfies the quarantine budgets
    and per-class floors; otherwise the run aborts with
    :class:`QuarantineBudgetExceeded`. Returns False for failures that are
    not quarantine-eligible (the caller must re-raise).
    """
    from ser_tpu_torch._internal.models.training_readiness import _allowed_media_roots

    classification = classify_failure(
        error,
        scope=FailureScope.SAMPLE,
        sample_path=sample_path,
        allowed_roots=_allowed_media_roots(settings),
    )
    if classification.disposition is not FailureDisposition.QUARANTINE:
        return False
    policy = QuarantinePolicy.from_settings(settings)
    projected = [*quarantined_labels, label]
    total = len(all_labels)
    if policy.strict:
        raise QuarantineBudgetExceeded(
            f"Strict quarantine mode refuses to drop {sample_path}."
        )
    if len(projected) > policy.max_absolute:
        raise QuarantineBudgetExceeded(
            f"Quarantining {sample_path} would exceed the absolute budget "
            f"({policy.max_absolute})."
        )
    if total and len(projected) / total > policy.max_global_ratio:
        raise QuarantineBudgetExceeded(
            f"Quarantining {sample_path} would exceed the global ratio budget "
            f"({policy.max_global_ratio})."
        )
    if label is not None:
        class_total = sum(1 for item in all_labels if item == label)
        class_lost = sum(1 for item in projected if item == label)
        if class_total and class_lost / class_total > policy.max_class_ratio:
            raise QuarantineBudgetExceeded(
                f"Quarantining {sample_path} would exceed class {label!r}'s "
                f"ratio budget ({policy.max_class_ratio})."
            )
        if class_total - class_lost < policy.min_remaining_per_class_split:
            raise QuarantineBudgetExceeded(
                f"Quarantining {sample_path} would leave class {label!r} below "
                f"the per-split floor ({policy.min_remaining_per_class_split})."
            )
    state = current_training_run()
    if state is not None:
        state.quarantined_sample_paths.append(sample_path)
    _record_containment("sample", classification.reason_code.value, "quarantine")
    logger.warning(
        "Quarantined mid-training sample %s (%s): %s",
        sample_path,
        classification.reason_code.value,
        classification.diagnostic,
    )
    return True


@contextmanager
def training_operation_scope(profile: ProfileName) -> Iterator[TrainingRunState]:
    """Opens one training operation scope (reference ``:163``)."""
    state = TrainingRunState(
        operation_id=uuid.uuid4().hex[:12],
        profile=profile,
        started_at_unix=time.time(),
    )
    token = _active_run.set(state)
    logger.info("Training operation %s started (profile=%s).", state.operation_id, profile)
    try:
        yield state
    finally:
        _active_run.reset(token)
        logger.info(
            "Training operation %s finished in %.1fs (phase=%s).",
            state.operation_id,
            time.time() - state.started_at_unix,
            state.phase,
        )


def ensure_entrypoint_readiness(
    *, settings: AppConfig, profile: ProfileName, smoke: bool = True, backend=None
) -> ReadinessReport:
    """Runs readiness (+ backend smoke) and raises on blocking findings.

    Reference ``:529-580``: the smoke encodes one real clip through the
    SELECTED backend under a hard wall-clock deadline
    (``training_orchestration.py:458-476``) so a hung or miswired backend
    fails here, not mid-training.
    """
    report = run_training_readiness(settings=settings, profile=profile)
    if smoke and not report.blocking:
        from ser_tpu_torch._internal.models.training_readiness import run_backend_smoke

        smoke_findings = run_backend_smoke(
            settings=settings,
            profile=profile,
            usable_files=report.usable_files,
            usable_records=report.usable_records,
            backend=backend,
        )
        if smoke_findings:
            report = ReadinessReport(
                profile=report.profile,
                findings=report.findings + tuple(smoke_findings),
                quarantined_files=report.quarantined_files,
                usable_files=report.usable_files,
            )
    state = current_training_run()
    if state is not None:
        state.readiness = report
        state.phase = "readiness_complete"
    try:
        from ser_tpu_torch._internal.models.training_readiness import write_readiness_report

        write_readiness_report(report, settings=settings)
    except Exception as err:  # noqa: BLE001 - audit artifact must not block training
        logger.warning("Could not persist readiness report: %s", err)
    if report.blocking:
        blocking = [f for f in report.findings if f.severity.value == "blocking"]
        raise TrainingNotReadyError(
            f"Training readiness failed with {len(blocking)} blocking finding(s): "
            + "; ".join(f.message for f in blocking[:3])
        )
    return report


__all__ = [
    "QuarantineBudgetExceeded",
    "TrainingNotReadyError",
    "TrainingRunState",
    "bounded_retry_local_io",
    "current_training_run",
    "ensure_entrypoint_readiness",
    "handle_sample_encoding_failure",
    "record_cache_probe",
    "training_operation_scope",
]
