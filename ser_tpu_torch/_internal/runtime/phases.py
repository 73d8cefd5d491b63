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
    "PHASE_EMOTION_INFERENCE",
    "PHASE_EMOTION_SETUP",
    "PHASE_TIMELINE_BUILD",
    "PHASE_TIMELINE_OUTPUT",
    "PHASE_TRANSCRIPTION",
    "PHASE_TRANSCRIPTION_MODEL_LOAD",
    "PHASE_TRANSCRIPTION_SETUP",
    "PHASE_WORKFLOW_TOTAL",
    "timed_phase",
]
