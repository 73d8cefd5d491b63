"""Training orchestration, first part: the run state of one training operation.

Counterpart of ``ser_tpu/_internal/models/training_orchestration.py:37-78,
218-238``: ``TrainingRunState``, scoped by a ``ContextVar``
(``training_operation_scope``, ``current_training_run``). The loader stamps
the audited recipe's digests on it for the artifact's metadata. Readiness
gating, quarantine and the entry points' mode dispatch come with the next
slice of the training pipeline (``ROADMAP.md``).
"""

from __future__ import annotations

import time
import uuid
from collections import Counter
from collections.abc import Iterator
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Any

from ser_tpu_torch._internal.utils.logger import get_logger
from ser_tpu_torch.profiles import ProfileName

logger = get_logger(__name__)


@dataclass
class TrainingRunState:
    """Mutable state of one training operation.

    Every contained failure leaves a ``scope:reason:disposition`` count in
    ``containment_counts`` for the training report.
    """

    operation_id: str
    profile: ProfileName
    started_at_unix: float
    phase: str = "pending"
    #: The readiness report (``training_readiness.ReadinessReport``, with the next slice).
    readiness: Any = None
    notes: list[str] = field(default_factory=list)
    containment_counts: Counter = field(default_factory=Counter)
    cache_hits: int = 0
    cache_misses: int = 0
    bounded_retries: int = 0
    quarantined_sample_paths: list[str] = field(default_factory=list)
    # The audited recipe's provenance, set by ``loader.apply_recipe_ledger``
    # and stamped into the artifact's metadata.
    recipe_digest: str | None = None
    split_ledger_digest: str | None = None


_active_run: ContextVar[TrainingRunState | None] = ContextVar("ser_tpu_torch_training_run", default=None)


def current_training_run() -> TrainingRunState | None:
    """The active training run's state, inside a scope; else None."""
    return _active_run.get()


@contextmanager
def training_operation_scope(profile: ProfileName) -> Iterator[TrainingRunState]:
    """Opens one training operation scope."""
    state = TrainingRunState(operation_id=uuid.uuid4().hex[:12], profile=profile, started_at_unix=time.time())
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


__all__ = ["TrainingRunState", "current_training_run", "training_operation_scope"]
