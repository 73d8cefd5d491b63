"""Workflow phase ids and the timer that records them.

Counterpart of ``ser_tpu/_internal/runtime/phases.py`` for the phases of the
accurate profile's inference, transcript included: the same names accumulate
into ``InferenceExecution.phase_timings_seconds``.
"""

from __future__ import annotations

import time
from collections.abc import Iterator
from contextlib import contextmanager

from ser_tpu_torch._internal.utils.logger import get_logger

logger = get_logger(__name__)

PHASE_WORKFLOW_TOTAL = "workflow_total"
PHASE_EMOTION_SETUP = "emotion_setup"
PHASE_EMOTION_INFERENCE = "emotion_inference"
PHASE_TRANSCRIPTION_SETUP = "transcription_setup"
PHASE_TRANSCRIPTION_MODEL_LOAD = "transcription_model_load"
PHASE_TRANSCRIPTION = "transcription"
PHASE_TIMELINE_BUILD = "timeline_build"
PHASE_TIMELINE_OUTPUT = "timeline_output"

ALL_PHASES: tuple[str, ...] = (
    PHASE_WORKFLOW_TOTAL,
    PHASE_EMOTION_SETUP,
    PHASE_EMOTION_INFERENCE,
    PHASE_TRANSCRIPTION_SETUP,
    PHASE_TRANSCRIPTION_MODEL_LOAD,
    PHASE_TRANSCRIPTION,
    PHASE_TIMELINE_BUILD,
    PHASE_TIMELINE_OUTPUT,
)

#: Human-readable labels of the phases.
PHASE_LABELS: dict[str, str] = {
    PHASE_WORKFLOW_TOTAL: "SER workflow",
    PHASE_EMOTION_SETUP: "Emotion setup",
    PHASE_EMOTION_INFERENCE: "Emotion inference",
    PHASE_TRANSCRIPTION_SETUP: "Transcription setup",
    PHASE_TRANSCRIPTION_MODEL_LOAD: "Transcription model load",
    PHASE_TRANSCRIPTION: "Transcription",
    PHASE_TIMELINE_BUILD: "Timeline build",
    PHASE_TIMELINE_OUTPUT: "Timeline output",
}


def phase_label(phase_name: str) -> str:
    """Human-readable label for one phase id (falls back to the id)."""
    return PHASE_LABELS.get(phase_name, phase_name)


@contextmanager
def timed_phase(phase: str, timings: dict[str, float]) -> Iterator[None]:
    """Adds the time spent in the block to ``timings[phase]``, also on failure."""
    logger.debug("phase %s started", phase)
    started = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - started
        timings[phase] = timings.get(phase, 0.0) + elapsed
        logger.debug("phase %s ended after %.3fs", phase, elapsed)


__all__ = [
    "ALL_PHASES",
    "PHASE_EMOTION_INFERENCE",
    "PHASE_EMOTION_SETUP",
    "PHASE_LABELS",
    "PHASE_TIMELINE_BUILD",
    "PHASE_TIMELINE_OUTPUT",
    "PHASE_TRANSCRIPTION",
    "PHASE_TRANSCRIPTION_MODEL_LOAD",
    "PHASE_TRANSCRIPTION_SETUP",
    "PHASE_WORKFLOW_TOTAL",
    "phase_label",
    "timed_phase",
]
