"""Transcription profiling: WER, latency percentiles, the persisted recommendation.

Counterpart of ``ser_tpu/_internal/transcript/profiling.py``: word error rate
against the canonical RAVDESS sentences, nearest-rank latency percentiles
per (backend, model) candidate, the default recommendation with its
confidence, and the calibration report that admission control reads. The
report is an artifact format (``ROADMAP.md`` rule (b)): its keys are the JAX
package's, so each package reads the reports the other writes.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import re
import time
from collections.abc import Callable
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ser_tpu_torch.domain import TranscriptWord

logger = logging.getLogger(__name__)

#: The two canonical RAVDESS statements (every clip speaks one of these).
RAVDESS_CANONICAL_SENTENCES: tuple[str, ...] = (
    "kids are talking by the door",
    "dogs are sitting by the door",
)


def _normalize_words(text: str) -> list[str]:
    """Lowercase words, punctuation as a separator: "door's" is ("door", "s")."""
    normalized = re.sub(r"[^a-z0-9 ]+", " ", text.strip().lower())
    return [token for token in normalized.split() if token]


def nearest_rank_percentile(values: list[float], fraction: float) -> float:
    """Nearest-rank percentile; an empty sample reports 1.0 (pessimistic)."""
    if not values:
        return 1.0
    rank = max(0, math.ceil(fraction * len(values)) - 1)
    return sorted(values)[rank]


def word_error_rate(reference: str, hypothesis: str) -> float:
    """Levenshtein WER over normalized lowercase alphanumeric words."""
    ref = _normalize_words(reference)
    hyp = _normalize_words(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    previous = list(range(len(hyp) + 1))
    for i, ref_word in enumerate(ref, start=1):
        current = [i] + [0] * len(hyp)
        for j, hyp_word in enumerate(hyp, start=1):
            substitution = previous[j - 1] + (ref_word != hyp_word)
            current[j] = min(previous[j] + 1, current[j - 1] + 1, substitution)
        previous = current
    return previous[-1] / len(ref)


@dataclass(frozen=True)
class TranscriptionCandidateReport:
    """Accuracy and latency profile of one (backend, model) candidate."""

    backend_id: str
    model_name: str
    mean_wer: float
    p50_latency_seconds: float
    p95_latency_seconds: float
    samples: int


@dataclass(frozen=True)
class CalibrationRecommendation:
    """A persisted default-model recommendation with its confidence."""

    backend_id: str
    model_name: str
    confidence: str  # "high" | "medium" | "low"
    mean_wer: float
    p50_latency_seconds: float
    generated_at_unix: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def profile_transcription_candidate(
    transcribe: Callable[[str], list[TranscriptWord]],
    samples: list[tuple[str, str]],  # (audio_path, reference_text)
    *,
    backend_id: str,
    model_name: str,
) -> TranscriptionCandidateReport:
    """WER and latency of one candidate over labeled samples.

    An untimed warm-up call runs first (weight load, the kernels' build), so
    the percentiles measure steady-state latency.
    """
    if not samples:
        raise ValueError("Need at least one labeled sample to profile.")
    transcribe(samples[0][0])
    wers, latencies = [], []
    for audio_path, reference in samples:
        start = time.perf_counter()
        words = transcribe(audio_path)
        latencies.append(time.perf_counter() - start)
        wers.append(word_error_rate(reference, " ".join(word.word for word in words)))
    return TranscriptionCandidateReport(
        backend_id=backend_id,
        model_name=model_name,
        mean_wer=float(np.mean(wers)),
        p50_latency_seconds=nearest_rank_percentile(latencies, 0.50),
        p95_latency_seconds=nearest_rank_percentile(latencies, 0.95),
        samples=len(samples),
    )


def recommend_default(
    reports: list[TranscriptionCandidateReport], *, max_acceptable_wer: float = 0.30
) -> CalibrationRecommendation:
    """The fastest candidate whose WER clears the gate.

    Confidence: high when the winner clears the gate with at least 3
    samples, medium with fewer, low when no candidate clears it (the lowest
    WER then wins).
    """
    if not reports:
        raise ValueError("No candidate reports to recommend from.")
    acceptable = [r for r in reports if r.mean_wer <= max_acceptable_wer]
    if acceptable:
        winner = min(acceptable, key=lambda r: r.p50_latency_seconds)
        confidence = "high" if winner.samples >= 3 else "medium"
    else:
        winner = min(reports, key=lambda r: r.mean_wer)
        confidence = "low"
    return CalibrationRecommendation(
        backend_id=winner.backend_id,
        model_name=winner.model_name,
        confidence=confidence,
        mean_wer=winner.mean_wer,
        p50_latency_seconds=winner.p50_latency_seconds,
        generated_at_unix=time.time(),
    )


def save_calibration_report(
    recommendation: CalibrationRecommendation, reports: list[TranscriptionCandidateReport], path: str | Path
) -> str:
    """Persists the calibration outcome (read by admission control)."""
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    target.write_text(
        json.dumps({"recommendation": recommendation.to_dict(), "candidates": [vars(r) for r in reports]}, indent=2),
        encoding="utf-8",
    )
    return str(target)


def load_calibration_report(path: str | Path) -> CalibrationRecommendation | None:
    """A persisted recommendation; None when missing or unreadable (a bad report reads as none)."""
    target = Path(path)
    if not target.exists():
        return None
    try:
        raw = json.loads(target.read_text(encoding="utf-8"))["recommendation"]
        report = CalibrationRecommendation(**raw)
        if report.confidence not in ("high", "medium", "low"):
            raise TypeError(f"invalid confidence {report.confidence!r}")
        float(report.generated_at_unix)
        float(report.mean_wer)
        return report
    except (OSError, KeyError, TypeError, ValueError) as err:
        logger.warning("Unreadable calibration report %s: %s", path, err)
        return None


def default_calibration_report_path(tmp_folder) -> Path:
    """The writer's default report location (shared with admission)."""
    return Path(tmp_folder) / "transcription_calibration.json"


__all__ = [
    "CalibrationRecommendation",
    "RAVDESS_CANONICAL_SENTENCES",
    "TranscriptionCandidateReport",
    "default_calibration_report_path",
    "load_calibration_report",
    "nearest_rank_percentile",
    "profile_transcription_candidate",
    "recommend_default",
    "save_calibration_report",
    "word_error_rate",
]
